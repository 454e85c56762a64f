"""Campaign-engine entry points for multi-accelerator (platform) sweeps
(own copy of the reference's ``experiments/multiacc.py``).

The partitioned multi-instance simulator
(``core.simulator.MultiAccelSimulator``) is, like the single-instance
one, embarrassingly parallel per (taskset, seed) point — so the fig11
sweep is declared as a :class:`~repro_torch.experiments.spec.FuncSweep` over
:func:`simulate_multiacc_point`, giving it the engine's process fan-out
and content-addressed result cache for free.

Seeding follows the engine's per-point contract
(``core.taskgen.point_seed``): set ``s`` generates its taskset AND runs
its simulator with ``seed0 + s``, so every point is reproducible in
isolation.  ``sim_v`` is accepted (and baked into the point's cache key
by the sweep declaration) so bumping
``core.simulator.MULTI_SIM_SEMANTICS_VERSION`` invalidates stale cached
rows without touching the single-instance campaign cache.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.scheduler import Policy
from repro_torch.core.simulator import MultiAccelSimulator
from repro_torch.core.taskgen import generate_taskset, point_seed
from repro_torch.experiments.metrics import metrics_row
from repro_torch.experiments.runner import cached_library

POLICIES = {
    "mesc": Policy.mesc,
    "np": Policy.non_preemptive,
    "lp": Policy.limited,
    "amc": Policy.amc,
}


def simulate_multiacc_point(*, policy: str, u: float, n_instances: int,
                            heuristic: str, set_index: int, seed0: int = 0,
                            n_tasks: int = 12, gamma: float = 0.5,
                            cf: float = 2.0, duration: float = 2e8,
                            overrun_prob: float = 0.3,
                            dma_contention: bool = True,
                            migration: bool = True,
                            max_task_u: float = 0.5,
                            library: str = "sim",
                            sim_v: Any = None) -> Dict[str, Any]:
    """One partitioned multi-accelerator DES run -> one tidy row.

    ``u`` is the TOTAL task-set utilisation (spread over the instances
    by the partition heuristic); ``policy`` is a name from
    :data:`POLICIES`.  Task sets use UUnifast-discard with
    ``max_task_u=0.5`` so every HI-task stays individually feasible
    under a full CF=2 overrun (u_lo <= 1/CF) — plain UUnifast over a
    multi-instance total would emit tasks no instance can host.
    Returns the merged platform-wide metrics row plus the multi-only
    counters (migrations, DMA-contention cycles).
    """
    from repro_torch.core.platform import MigrationPolicy
    del sim_v                       # cache-key salt only
    programs = cached_library(library)
    seed = point_seed(seed0, set_index)
    tasks = generate_taskset(u, gamma=gamma, n_tasks=n_tasks, cf=cf,
                             seed=seed, programs=programs,
                             max_task_u=max_task_u)
    sim = MultiAccelSimulator(
        tasks, programs, POLICIES[policy](), n_instances=n_instances,
        heuristic=heuristic, duration=duration, seed=seed,
        overrun_prob=overrun_prob, cf=cf, dma_contention=dma_contention,
        migration=MigrationPolicy(enabled=migration))
    multi = sim.run()
    merged = multi.merged()
    row = metrics_row(merged, policy=policy, u=u,
                      n_instances=n_instances, heuristic=heuristic,
                      set_index=set_index, seed=seed)
    blocks = merged.pi_blocking + merged.ci_blocking
    row.update(
        migrations=multi.migrations,
        migration_cycles=float(multi.migration_cycles),
        dma_contention_cycles=float(multi.dma_contention_cycles),
        block_max=float(max(blocks)) if blocks else 0.0,
    )
    return row
