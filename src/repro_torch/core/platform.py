"""Multi-accelerator platform: partitioned MCS scheduling across N
virtual Gemmini^RT instances (scale-out of the paper's SS IV/V mechanism);
own copy of the reference's ``core/platform.py``.

The paper makes ONE streaming accelerator preemptible at instruction
granularity; real MCS platforms (heterogeneous MPSoCs, serving fleets)
schedule criticality-mixed task sets across *pools* of such co-processors.
This module supplies the static half of that generalisation:

  * :class:`AcceleratorPool` — N instances, each with its own bank
    remapper/mode state, sharing one DMA path to DRAM (the contention
    the multi-instance simulator and the partitioned analysis charge);
  * task -> instance *partitioning* (:func:`partition`) with three
    heuristics: ``first_fit`` (decreasing-utilisation bin packing),
    ``worst_fit`` (load balancing), and ``crit_aware`` (spread HI-tasks
    evenly, then steer LO-tasks toward HI-light instances so a mode
    switch on one instance degrades as few LO-tasks as possible);
  * LO-task **migration-on-idle** (:class:`MigrationPolicy`): a LO-task
    waiting behind work on its home instance may move to an instance
    that has gone idle in LO-mode, paying the DMA cost of shipping its
    saved context.

The dynamic halves live next door: per-instance mode machines plus the
global coordinator in ``core.scheduler``, the multi-instance event loop
in ``core.simulator.MultiAccelSimulator``, and the partitioned
response-time analysis in ``core.wcrt.analyze_partitioned``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core.executor import GemminiRT
from repro_torch.core.task import Crit, TaskParams

HEURISTICS = ("first_fit", "worst_fit", "crit_aware")


def utilization(tasks: Sequence[TaskParams], *, hi: bool = False) -> float:
    """Sum of C/T over the tasks (C_HI for ``hi=True``)."""
    return sum((t.c_hi if hi else t.c_lo) / t.period for t in tasks)


@dataclasses.dataclass
class Assignment:
    """A static task -> instance partition plus derived views.

    ``task_to_instance`` is the *current* placement (a migrated job
    runs away from home); ``home`` is the heuristic's static partition
    a task returns to when its migrated job completes — migration is
    job-scoped, so the partition (and its analysis) never erodes.
    """
    n_instances: int
    heuristic: str
    task_to_instance: Dict[int, int]
    home: Dict[int, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.home:
            self.home = dict(self.task_to_instance)

    def instance_of(self, tid: int) -> int:
        return self.task_to_instance[tid]

    def home_of(self, tid: int) -> int:
        return self.home[tid]

    def tasks_on(self, inst: int,
                 tasks: Sequence[TaskParams]) -> List[TaskParams]:
        return [t for t in tasks if self.task_to_instance[t.tid] == inst]

    def migrate(self, tid: int, inst: int) -> None:
        self.task_to_instance[tid] = inst

    def return_home(self, tid: int) -> None:
        self.task_to_instance[tid] = self.home[tid]


def _first_fit(tasks: List[TaskParams], n: int) -> Dict[int, int]:
    """Decreasing-utilisation first-fit; a task that fits nowhere under
    the U<=1 capacity test goes to the least-loaded instance."""
    load = [0.0] * n
    out: Dict[int, int] = {}
    for t in sorted(tasks, key=lambda t: -(t.c_lo / t.period)):
        u = t.c_lo / t.period
        inst = next((i for i in range(n) if load[i] + u <= 1.0), None)
        if inst is None:
            inst = min(range(n), key=load.__getitem__)
        load[inst] += u
        out[t.tid] = inst
    return out


def _worst_fit(tasks: List[TaskParams], n: int) -> Dict[int, int]:
    """Decreasing-utilisation worst-fit: always the least-loaded
    instance — balances load, minimising per-instance peak demand."""
    load = [0.0] * n
    out: Dict[int, int] = {}
    for t in sorted(tasks, key=lambda t: -(t.c_lo / t.period)):
        inst = min(range(n), key=load.__getitem__)
        load[inst] += t.c_lo / t.period
        out[t.tid] = inst
    return out


def _crit_aware(tasks: List[TaskParams], n: int) -> Dict[int, int]:
    """Criticality-aware partition: HI-tasks worst-fit over HI-load
    first (spreads the overrun/mode-switch blast radius), then LO-tasks
    placed by combined load with HI-load weighted double — LO-tasks
    gravitate to HI-light instances, so fewer of them sit on an
    instance that leaves LO-mode."""
    hi_load = [0.0] * n
    lo_load = [0.0] * n
    out: Dict[int, int] = {}
    his = [t for t in tasks if t.crit == Crit.HI]
    los = [t for t in tasks if t.crit == Crit.LO]
    for t in sorted(his, key=lambda t: -(t.c_hi / t.period)):
        inst = min(range(n), key=hi_load.__getitem__)
        hi_load[inst] += t.c_hi / t.period
        out[t.tid] = inst
    for t in sorted(los, key=lambda t: -(t.c_lo / t.period)):
        inst = min(range(n),
                   key=lambda i: lo_load[i] + 2.0 * hi_load[i])
        lo_load[inst] += t.c_lo / t.period
        out[t.tid] = inst
    return out


_HEURISTIC_FNS = {"first_fit": _first_fit, "worst_fit": _worst_fit,
                  "crit_aware": _crit_aware}


def partition(tasks: Sequence[TaskParams], n_instances: int,
              heuristic: str = "crit_aware") -> Assignment:
    """Statically partition ``tasks`` over ``n_instances`` accelerators."""
    if n_instances < 1:
        raise ValueError(f"n_instances must be >= 1, got {n_instances}")
    if heuristic not in _HEURISTIC_FNS:
        raise ValueError(f"unknown heuristic {heuristic!r}; "
                         f"choose from {HEURISTICS}")
    mapping = _HEURISTIC_FNS[heuristic](list(tasks), n_instances)
    return Assignment(n_instances=n_instances, heuristic=heuristic,
                      task_to_instance=mapping)


# ----------------------------------------------------------------------
@dataclasses.dataclass
class MigrationPolicy:
    """LO-task migration-on-idle knobs.

    ``enabled``        master switch;
    ``cost_per_byte``  extra DMA cycles charged per byte of saved
                       context shipped between instances (the shared
                       DRAM path makes this a copy, not a remap);
    ``lo_mode_only``   only migrate onto instances still in LO-mode
                       (never feed LO work to a degraded instance);
    ``min_wait``       a task must have been waiting this many cycles
                       since release before it may migrate — an idle
                       home instance will usually pick it up sooner,
                       so eager migration just burns shared DMA;
    ``cooldown``       cycles between migrations of the same task
                       (ping-pong damping; ~one migration per job);
    ``hi_slack_guard`` criticality-aware admission test: refuse a
                       migrant whose worst-case preemption cost (its
                       longest instruction + a fully DMA-contended
                       save/restore), scaled by ``slack_margin``,
                       exceeds the static slack D - C_HI of any
                       HI-task on the target — a migrant LO-task must
                       never be able to turn a schedulable HI-task
                       into a missing one;
    ``slack_margin``   safety factor on that cost bound (the static
                       slack ignores tick quantisation and chained
                       migrant restores, so demand margin).
    """
    enabled: bool = True
    cost_per_byte: float = 1.0 / 16.0     # one shared 128-bit DMA bus
    lo_mode_only: bool = True
    min_wait: float = 20_000.0            # 4 scheduler periods
    cooldown: float = 1e6
    hi_slack_guard: bool = True
    slack_margin: float = 2.0


class AcceleratorPool:
    """N virtual Gemmini^RT instances behind one shared DMA path.

    Owns per-instance accelerator models and the mutable task->instance
    assignment; the simulator drives it, the coordinator reads it.
    """

    def __init__(self, n_instances: int, *, use_remapper: bool = True,
                 heuristic: str = "crit_aware",
                 migration: Optional[MigrationPolicy] = None):
        if n_instances < 1:
            raise ValueError("need at least one accelerator instance")
        self.n_instances = n_instances
        self.heuristic = heuristic
        self.migration = migration or MigrationPolicy()
        self.instances: List[GemminiRT] = [
            GemminiRT(use_remapper=use_remapper) for _ in range(n_instances)]
        self.assignment: Optional[Assignment] = None
        self.migrations = 0

    def assign(self, tasks: Sequence[TaskParams]) -> Assignment:
        self.assignment = partition(tasks, self.n_instances,
                                    self.heuristic)
        return self.assignment

    def accel_of(self, tid: int) -> GemminiRT:
        assert self.assignment is not None, "assign() first"
        return self.instances[self.assignment.instance_of(tid)]

    def migrate(self, tid: int, dst: int) -> float:
        """Move ``tid``'s saved context to instance ``dst``; returns the
        DMA cycles charged for shipping it over the shared path."""
        assert self.assignment is not None, "assign() first"
        src = self.assignment.instance_of(tid)
        if src == dst:
            return 0.0
        src_acc, dst_acc = self.instances[src], self.instances[dst]
        ctx = src_acc.dram.pop(tid, None)
        cycles = 0.0
        if ctx is not None:
            moved = ctx.get("accumulator", 0) + ctx.get("scratchpad", 0)
            # context saved "kept_resident" on the source must be
            # evacuated there before it can move
            if ctx.get("kept_resident"):
                moved += src_acc.remapper.resident_bytes(tid)
                ctx["scratchpad"] += src_acc.remapper.resident_bytes(tid)
                ctx["kept_resident"] = False
            dst_acc.dram[tid] = ctx
            cycles = moved * self.migration.cost_per_byte
        src_acc.remapper.release(tid)
        src_acc.accum_bytes_used.pop(tid, None)
        src_acc.spad_bytes.pop(tid, None)
        self.assignment.migrate(tid, dst)
        self.migrations += 1
        return cycles
