"""Worst-Case Response Time analysis for MESC (paper SS VII, Eqs. 1-11);
own copy of the reference's ``core/wcrt.py``.

Notation (all cycles):
  I(G)            longest single accelerator-instruction time in task set G
  T_sr            scheduler period
  Y_S / Y_R       max context save / restore durations (accelerator + CPU)
  Y_C             max CPU check time per scheduler invocation
  Y_CC            max CPU-only-task context switch time

Three schedulability cases: LO-mode (Eq. 3), HI-mode (Eq. 7), and mode
transition (Eq. 11), each a fixed-point recurrence solved iteratively.
A task set is schedulable iff every task passes its applicable cases.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from repro_torch.core.program import Program
from repro_torch.core.task import Crit, TaskParams


@dataclasses.dataclass(frozen=True)
class AnalysisConstants:
    t_sr: float = 5000.0
    y_save: float = 12000.0       # Upsilon^S_Asr (measured; fig7 benchmark)
    y_restore: float = 12000.0    # Upsilon^R_Asr
    y_check: float = 200.0        # Upsilon_Csr
    y_cpu_cs: float = 500.0       # Upsilon^C_Csr


def longest_instruction(tasks: List[TaskParams],
                        programs: Dict[str, Program]) -> float:
    """I(F(G)): max instruction execution time among accelerator tasks."""
    accel = [t for t in tasks if t.uses_accelerator and t.workload]
    if not accel:
        return 0.0
    return max(programs[t.workload].max_instruction_cycles for t in accel)


def _partitions(tasks: List[TaskParams], ti: TaskParams):
    hpH = [t for t in tasks if t.priority < ti.priority and t.crit == Crit.HI]
    hpL = [t for t in tasks if t.priority < ti.priority and t.crit == Crit.LO]
    lpH = [t for t in tasks if t.priority > ti.priority and t.crit == Crit.HI]
    lpL = [t for t in tasks if t.priority > ti.priority and t.crit == Crit.LO]
    return hpH, hpL, lpH, lpL


def _F(ts):          # accelerator-using subset
    return [t for t in ts if t.uses_accelerator]


def _Fbar(ts):       # CPU-only subset
    return [t for t in ts if not t.uses_accelerator]


def _I(ts, programs) -> float:
    return longest_instruction(ts, programs)


def _solve(rhs, r0: float, bound: float) -> Optional[float]:
    """Fixed-point iteration R = rhs(R); None if it exceeds ``bound``."""
    r = r0
    for _ in range(500):
        nxt = rhs(r)
        if nxt <= r + 1e-6:
            return nxt
        if nxt > bound:
            return None
        r = nxt
    return None


def response_time_lo(ti: TaskParams, tasks, programs,
                     k: AnalysisConstants) -> Optional[float]:
    """Eq. 3 with blocking from Eqs. 1-2."""
    hpH, hpL, lpH, lpL = _partitions(tasks, ti)
    pb = _I(_F(lpH + lpL), programs) + k.t_sr          # Eq. 1
    b = pb                                             # Eq. 2
    cpu_hp = _Fbar(hpH + hpL)
    acc_hp = _F(hpH + hpL)

    def rhs(r):
        val = b + ti.c_lo + k.y_save + k.y_restore
        val += math.ceil(r / k.t_sr) * k.y_check
        for tj in cpu_hp:
            val += math.ceil(r / tj.period) * (2 * k.y_cpu_cs + tj.c_lo)
        for tk_ in acc_hp:
            val += math.ceil(r / tk_.period) * (k.y_save + k.y_restore
                                                + tk_.c_lo)
        return val

    return _solve(rhs, ti.c_lo, ti.deadline)


def response_time_hi(ti: TaskParams, tasks, programs,
                     k: AnalysisConstants) -> Optional[float]:
    """Eq. 7 with blocking from Eqs. 4-6 (HI-tasks only)."""
    assert ti.crit == Crit.HI
    hpH, hpL, lpH, lpL = _partitions(tasks, ti)
    b = _I(_F(lpL + hpL + lpH), programs) + k.t_sr     # Eq. 6
    cpu_hp = _Fbar(hpH)
    acc_hp = _F(hpH)

    def rhs(r):
        val = b + ti.c_hi + k.y_save + k.y_restore
        val += math.ceil(r / k.t_sr) * k.y_check
        for tj in cpu_hp:
            val += math.ceil(r / tj.period) * (2 * k.y_cpu_cs + tj.c_hi)
        for tk_ in acc_hp:
            val += math.ceil(r / tk_.period) * (k.y_save + k.y_restore
                                                + tk_.c_hi)
        return val

    return _solve(rhs, ti.c_hi, ti.deadline)


def response_time_trans(ti: TaskParams, tasks, programs,
                        k: AnalysisConstants) -> Optional[float]:
    """Eq. 11: released in LO/transition, finishes in transition/HI.

    LO-task preemptions of tau_i can only have happened while still in
    LO-mode, so their interference is windowed by R_i^LO (per the paper we
    upper-bound it with the LO response time; if tau_i is unschedulable in
    LO-mode the transition case fails too)."""
    assert ti.crit == Crit.HI
    hpH, hpL, lpH, lpL = _partitions(tasks, ti)
    b = _I(_F(lpL + hpL + lpH), programs) + k.t_sr     # Eqs. 8-10
    r_lo = response_time_lo(ti, tasks, programs, k)
    if r_lo is None:
        return None
    cpu_hpL, acc_hpL = _Fbar(hpL), _F(hpL)
    cpu_hpH, acc_hpH = _Fbar(hpH), _F(hpH)

    def rhs(r):
        val = b + ti.c_hi + k.y_save + k.y_restore
        val += math.ceil(r / k.t_sr) * k.y_check
        for tj in cpu_hpL:
            val += math.ceil(r_lo / tj.period) * (2 * k.y_cpu_cs + tj.c_lo)
        for tj in cpu_hpH:
            val += math.ceil(r / tj.period) * (2 * k.y_cpu_cs + tj.c_hi)
        for tm in acc_hpL:
            val += math.ceil(r_lo / tm.period) * (k.y_save + k.y_restore
                                                  + tm.c_lo)
        for tn in acc_hpH:
            val += math.ceil(r / tn.period) * (k.y_save + k.y_restore
                                               + tn.c_hi)
        return val

    return _solve(rhs, ti.c_hi, ti.deadline)


@dataclasses.dataclass
class SchedulabilityResult:
    schedulable: bool
    lo: Dict[int, Optional[float]]
    hi: Dict[int, Optional[float]]
    trans: Dict[int, Optional[float]]


@dataclasses.dataclass
class PartitionedSchedulability:
    """Partitioned analysis verdict: per-instance results + platform OK."""
    schedulable: bool
    per_instance: Dict[int, SchedulabilityResult]
    assignment: "object"                 # core.platform.Assignment


def analyze_partitioned(tasks: List[TaskParams],
                        programs: Dict[str, Program], *,
                        n_instances: int,
                        heuristic: str = "crit_aware",
                        k: AnalysisConstants = AnalysisConstants(),
                        dma_contention: bool = True,
                        assignment=None) -> PartitionedSchedulability:
    """Partitioned response-time analysis over N accelerator instances.

    Each instance is analysed as its own single-accelerator system
    (Eqs. 1-11) over *its partition only* — assignment-aware blocking:
    the I(G) term and the hp/lp interference sets shrink to the tasks
    actually co-located with tau_i, which is exactly why partitioning
    helps.  The shared-DMA path couples the instances through the
    context-switch terms: in the worst case every other instance is
    mid-save/restore concurrently, so with ``dma_contention`` the
    per-instance Upsilon^S/Upsilon^R constants are stretched by
    ``n_instances`` (equal-share bandwidth model, matching
    ``simulator.MultiAccelSimulator``).

    A task set is platform-schedulable iff every instance's partition
    passes all of its applicable LO/HI/transition cases.
    """
    from repro_torch.core.platform import partition
    if assignment is None:
        assignment = partition(tasks, n_instances, heuristic)
    stretch = float(n_instances) if dma_contention else 1.0
    k_inst = dataclasses.replace(k, y_save=k.y_save * stretch,
                                 y_restore=k.y_restore * stretch)
    per: Dict[int, SchedulabilityResult] = {}
    ok = True
    for inst in range(n_instances):
        subset = assignment.tasks_on(inst, tasks)
        if not subset:
            per[inst] = SchedulabilityResult(True, {}, {}, {})
            continue
        res = analyze(subset, programs, k_inst)
        per[inst] = res
        ok = ok and res.schedulable
    return PartitionedSchedulability(ok, per, assignment)


def analyze(tasks: List[TaskParams], programs: Dict[str, Program],
            k: AnalysisConstants = AnalysisConstants()) -> SchedulabilityResult:
    lo, hi, tr = {}, {}, {}
    ok = True
    for t in tasks:
        r = response_time_lo(t, tasks, programs, k)
        lo[t.tid] = r
        if r is None or r > t.deadline:
            ok = False
        if t.crit == Crit.HI:
            r2 = response_time_hi(t, tasks, programs, k)
            hi[t.tid] = r2
            r3 = response_time_trans(t, tasks, programs, k)
            tr[t.tid] = r3
            if r2 is None or r2 > t.deadline:
                ok = False
            if r3 is None or r3 > t.deadline:
                ok = False
    return SchedulabilityResult(ok, lo, hi, tr)
