"""Task-set generation (paper SS VIII 'Task set setup'); own copy of the
reference's ``core/taskgen.py``, making the same ``np.random.default_rng``
draws in the same order.

* utilisations via UUnifast (unbiased);
* C_LO drawn from the workload library's measured total cycles;
* C_HI = CF * C_LO (default CF = 2.0);
* T_i = C_LO / U_i, implicit deadlines D_i = T_i;
* fixed priorities in ascending order of T_i (rate monotonic);
* HI-task share gamma (default 0.5); beta tasks per set (default 10).

Seeding contract: set ``s`` of a batch anchored at ``seed0`` is
generated from ``point_seed(seed0, s) == seed0 + s``, and the simulator
run over that set uses the *same* seed.  Every (seed0, s) point is
therefore reproducible in isolation — independent of worker count,
execution order, or which other points run.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.program import Program, workload_library
from repro_torch.core.task import Crit, TaskParams
from repro_torch.core.isa import BANK_BYTES, SCRATCHPAD_BANKS


def uunifast(n: int, total_u: float, rng: np.random.Generator) -> np.ndarray:
    u = np.empty(n)
    s = total_u
    for i in range(n - 1):
        nxt = s * rng.random() ** (1.0 / (n - 1 - i))
        u[i] = s - nxt
        s = nxt
    u[-1] = s
    return u


def uunifast_discard(n: int, total_u: float, rng: np.random.Generator,
                     max_u: float = 1.0, max_tries: int = 10_000
                     ) -> np.ndarray:
    """UUnifast-Discard (Davis & Burns): redraw until every per-task
    share is <= ``max_u``.  Required for multiprocessor/partitioned
    totals (total_u > 1), where plain UUnifast can emit a single task
    no instance could ever host — e.g. a HI-task with u_lo > 1/CF can
    miss its own implicit deadline on an idle accelerator."""
    for _ in range(max_tries):
        u = uunifast(n, total_u, rng)
        if u.max() <= max_u:
            return u
    raise ValueError(f"no {n}-task UUnifast draw with total {total_u} "
                     f"fits max_u={max_u} after {max_tries} tries")


def eta_for(program: Program) -> int:
    """Minimal banks preserving full speed (SS VII.C, Fig. 6 analogue):
    working set rounded up to banks, capped at the scratchpad."""
    eta = max(1, -(-program.working_set_bytes // BANK_BYTES))
    return min(eta, SCRATCHPAD_BANKS)


def point_seed(seed0: int, set_index: int) -> int:
    """Deterministic per-point seed: see the module seeding contract."""
    return int(seed0) + int(set_index)


def generate_taskset(total_u: float, *, n_tasks: int = 10,
                     gamma: float = 0.5, cf: float = 2.0,
                     seed: int = 0,
                     programs: Optional[Dict[str, Program]] = None,
                     workload_names: Optional[Sequence[str]] = None,
                     max_task_u: Optional[float] = None,
                     ) -> List[TaskParams]:
    """One UUnifast task set (``max_task_u`` switches to the discard
    variant — use it whenever ``total_u`` targets a multi-instance
    platform; ``None`` keeps the legacy single-accelerator draws and
    their campaign-cache results byte-identical)."""
    rng = np.random.default_rng(seed)
    programs = programs or workload_library()
    names = list(workload_names or
                 [n for n in programs
                  if programs[n].total_cycles < 2e7])  # keep periods tractable
    if max_task_u is None:
        u = uunifast(n_tasks, total_u, rng)
    else:
        u = uunifast_discard(n_tasks, total_u, rng, max_u=max_task_u)
    chosen = rng.choice(names, size=n_tasks)
    n_hi = int(round(gamma * n_tasks))
    crits = np.array([Crit.HI] * n_hi + [Crit.LO] * (n_tasks - n_hi))
    rng.shuffle(crits)
    tasks = []
    for i in range(n_tasks):
        prog = programs[chosen[i]]
        c_lo = float(prog.total_cycles)
        period = c_lo / max(u[i], 1e-6)
        tasks.append(TaskParams(
            tid=i, priority=0, period=period, deadline=period,
            c_lo=c_lo, c_hi=cf * c_lo, crit=crits[i],
            eta=eta_for(prog), workload=chosen[i]))
    # rate-monotonic: shorter period -> higher priority (smaller number)
    for prio, t in enumerate(sorted(tasks, key=lambda t: t.period)):
        t.priority = prio
    return tasks


def generate_taskset_batch(total_u: float, n_sets: int, *, seed0: int = 0,
                           **kw) -> List[List[TaskParams]]:
    """Batch entry point: ``n_sets`` independent task sets following the
    per-point seeding contract (set ``s`` uses ``point_seed(seed0, s)``)."""
    return [generate_taskset(total_u, seed=point_seed(seed0, s), **kw)
            for s in range(n_sets)]
