"""Cycle-level discrete-event simulation of MESC (and baselines): the
runtime semantics of SS IV (scheduling/modes) + SS V (context-switch
costs) driving the SS VIII experiments.  Own copy of the reference's
``core/simulator.py``: the same host arithmetic in the same order and
the same ``np.random.default_rng(seed)`` draws, so every run equals the
reference's bit for bit.

Implements the paper's runtime semantics on a virtual 100 MHz clock:

  * the task scheduler runs every T_sr cycles (releases observed at ticks —
    the +T_sr term of Eq. 1);
  * job completion and LO-WCET overruns (the monitor's per-task timers)
    interrupt immediately;
  * a preemption drains the in-flight instruction (instruction policy), or
    runs to the operator boundary (limited preemption), or cannot happen
    at all (non-preemptive baseline);
  * context save/restore cycles come from the GemminiRT executor model —
    including the zero-scratchpad-copy fast path when the bank allocator
    finds room (Obs. 1);
  * mode transitions follow scheduler.update_mode; AMC drops LO jobs.

Metrics recorded per run: pi/ci blocking intervals, save/restore cycle
breakdowns, deadline misses per criticality, LO jobs released & completed
in HI-mode (survivability), mode residency.

Entry points: ``simulate`` runs one (taskset, seed) point;
``simulate_batch`` runs a list of such points serially in-process;
``simulate_multi`` runs the partitioned multi-accelerator variant
(``MultiAccelSimulator``, platform layer).  Runs
are fully independent — all randomness comes from the per-run
``np.random.default_rng(seed)`` — which is what lets the campaign
engine (``repro_torch.experiments``) fan points out across worker processes
and cache each point by content hash without changing any result.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
from heapq import heappush
from typing import Dict, List, Optional, Union

import numpy as np

from repro_torch.core.executor import GemminiRT
from repro_torch.core.program import Program
from repro_torch.scenarios import (demand_multiplier, get_scenario,
                                   shifted_phases)
from repro_torch.core.scheduler import (ACTIVE, Mode, Policy, pick_next,
                                        update_mode)
from repro_torch.core.task import Crit, Status, TCB, TaskParams

# Fingerprint of the simulation semantics, baked into every campaign
# cache key (repro_torch.experiments.spec).  It equals the reference's:
# both packages share the cache, and a port row is the reference's row.
# A change that alters any simulated result must move this salt off the
# reference's value — otherwise the shared cache serves stale rows.
SIM_SEMANTICS_VERSION = 1

# Same contract for the multi-accelerator path (MultiAccelSimulator /
# platform / migration): multi-instance sweeps salt their cache keys
# with this so multi semantics can evolve without invalidating the
# single-instance campaign cache.  v5 = job-scoped migration, HI-slack
# admission guard, migration retry + idle-wake ticks, un-double-counted
# overhead.
MULTI_SIM_SEMANTICS_VERSION = 5


class EventKind(enum.IntEnum):
    """Interned event kinds for the heap tuples (hot loop: comparing and
    hashing small ints beats per-event string handling)."""
    RELEASE = 0
    FINISH = 1
    OVERRUN = 2
    TICK = 3


# plain ints in the hot loop (IntEnum __eq__ costs a descriptor hop)
_RELEASE = int(EventKind.RELEASE)
_FINISH = int(EventKind.FINISH)
_OVERRUN = int(EventKind.OVERRUN)
_TICK = int(EventKind.TICK)

#: Demand profiles every engine understands.  "sampled" draws each
#: release's demand from the host rng stream (the engines' historical
#: behaviour); "nominal" pins demand at c_lo and consumes zero draws
#: (the vec<->jit bit-exactness corpus).  Canonical definition lives
#: here (the event engine is the semantic reference); simulator_vec
#: re-exports it.
DEMAND_PROFILES = ("sampled", "nominal")


class AggSamples:
    """Sum/count aggregate standing in for a per-event sample list.

    The jit lockstep backend (``core.simulator_jit``) accumulates
    blocking/save/restore statistics on-device as ``(total, n)`` pairs
    instead of materializing unbounded per-event lists; RunMetrics
    fields typed ``List[float]`` may hold one of these instead.
    ``metrics_row`` consumes either form — the totals are accumulated
    in event order, so on a trajectory identical to the NumPy engine's
    the flattened row is bit-identical too.
    """
    __slots__ = ("total", "n")

    def __init__(self, total: float, n: int):
        self.total = float(total)
        self.n = int(n)

    def __len__(self) -> int:
        return self.n

    @property
    def mean(self) -> float:
        """Mean of the aggregated samples; NaN for an empty aggregate
        (a run with zero blocking/save/restore events is normal — it
        must not raise ``ZeroDivisionError`` in a metrics pipeline)."""
        if self.n == 0:
            return float("nan")
        return self.total / self.n

    def __eq__(self, other) -> bool:
        return (isinstance(other, AggSamples)
                and self.total == other.total and self.n == other.n)

    def __iter__(self):
        raise TypeError(
            "AggSamples is a sum/count aggregate, not a sample list — "
            "read .total/.n (or go through metrics_row); the jit "
            "backend does not materialize per-event samples")

    def __repr__(self) -> str:
        return f"AggSamples(total={self.total!r}, n={self.n})"


# per-event sample lists, or AggSamples when the producing engine
# (core.simulator_jit) carries aggregates instead
Samples = Union[List[float], AggSamples]


@dataclasses.dataclass
class RunMetrics:
    pi_blocking: Samples = dataclasses.field(default_factory=list)
    ci_blocking: Samples = dataclasses.field(default_factory=list)
    save_cycles: Samples = dataclasses.field(default_factory=list)
    restore_cycles: Samples = dataclasses.field(default_factory=list)
    jobs: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"LO": 0, "HI": 0})
    done: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"LO": 0, "HI": 0})
    misses: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"LO": 0, "HI": 0})
    misses_by_mode: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"LO": 0, "transition": 0, "HI": 0})
    lo_released_in_hi: int = 0
    lo_done_in_hi: int = 0
    mode_cycles: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"LO": 0.0, "transition": 0.0, "HI": 0.0})
    cs_count: int = 0
    exec_cycles: float = 0.0
    overhead_cycles: float = 0.0

    def success(self, scope: str = "all") -> bool:
        if scope == "HI":
            return self.misses["HI"] == 0
        return self.misses["HI"] == 0 and self.misses["LO"] == 0

    def survivability(self) -> float:
        if self.lo_released_in_hi == 0:
            return 1.0
        return self.lo_done_in_hi / self.lo_released_in_hi


class DemandSampler:
    """One scenario-aware demand/overrun sampler shared by the single-
    and multi-accelerator event engines (hoisted from their previously
    duplicated ``_sample_demand`` bodies, so the scenario hooks cannot
    drift between the two paths).

    Draw-order contract (bit-exactness vs the vec engine): the
    "sampled" profile consumes, per *accepted* release, exactly one
    ``rng.random()`` overrun coin for HI tasks plus one ``rng.uniform``
    magnitude; the "nominal" profile consumes no draws.  Scenario
    multipliers never touch the host stream: they are counter-based CRN
    draws keyed ``(seed, component, task_column, release_index)`` — the
    same keys the vec/jit lockstep uses — where ``release_index``
    counts *every* release event (accepted, busy-missed, or AMC-
    dropped), making the fault realization policy-independent.
    """

    def __init__(self, rng, tasks, *, seed, overrun_prob, cf,
                 demand_profile="sampled", scenario=None):
        if demand_profile not in DEMAND_PROFILES:
            raise ValueError(
                f"unknown demand_profile {demand_profile!r}; want one "
                f"of {DEMAND_PROFILES}")
        self.rng = rng
        self.overrun_prob = overrun_prob
        self.cf = cf
        self.nominal = demand_profile == "nominal"
        self.scenario = get_scenario(scenario)
        self.seed64 = np.uint64(np.int64(seed))
        self._col = {t.tid: np.uint64(i) for i, t in enumerate(tasks)}
        self._rel_n: Dict[int, int] = {t.tid: 0 for t in tasks}

    def count_release(self, tid: int) -> int:
        """Absolute release index of this release event — the host twin
        of the vec/jit engines' ``sn`` scenario counter.  Call once at
        release-handler entry (before any accept/drop gate); the draw
        for the release uses the returned pre-bump value."""
        n = self._rel_n[tid]
        self._rel_n[tid] = n + 1
        return n

    def shift_phase(self, tid: int, phase: float, period: float) -> float:
        """Apply the scenario's phase-shift component to one task's
        host-drawn initial release phase."""
        scen = self.scenario
        if scen is None or not scen.has_phase_shift:
            return phase
        return float(shifted_phases(scen, self.seed64, self._col[tid],
                                    phase, period))

    def sample(self, p: TaskParams, rel_n: int, t: float) -> float:
        """Demand for one accepted release of task ``p`` (release index
        ``rel_n``, release time ``t``)."""
        if self.nominal:
            d = p.c_lo
        elif p.crit == Crit.HI and self.rng.random() < self.overrun_prob:
            d = p.c_lo * self.rng.uniform(1.0, self.cf)
        else:
            d = p.c_lo * self.rng.uniform(0.7, 1.0)
        scen = self.scenario
        if scen is not None and scen.affects_demand:
            m = demand_multiplier(scen, np, self.seed64, self._col[p.tid],
                                  np.uint64(rel_n), np.float64(t))
            d = d * float(m)
        return d


class MCSSimulator:
    def __init__(self, tasks: List[TaskParams], programs: Dict[str, Program],
                 policy: Policy, *, duration: float = 2e7, seed: int = 0,
                 overrun_prob: float = 0.3, cf: float = 2.0,
                 demand_profile: str = "sampled", scenario=None):
        self.params = {t.tid: t for t in tasks}
        self.programs = programs
        self.policy = policy
        self.duration = duration
        self.rng = np.random.default_rng(seed)
        self.overrun_prob = overrun_prob
        self.cf = cf
        self.sampler = DemandSampler(
            self.rng, tasks, seed=seed, overrun_prob=overrun_prob, cf=cf,
            demand_profile=demand_profile, scenario=scenario)
        self.accel = GemminiRT(use_remapper=policy.use_banks)
        self.tcbs: Dict[int, TCB] = {t.tid: TCB(params=t) for t in tasks}
        self.metrics = RunMetrics()
        self.mode = Mode.LO
        self.now = 0.0
        self.running: Optional[int] = None
        self.accel_free_at = 0.0     # context switch in progress until here
        self.demand: Dict[int, float] = {}
        self._events: List = []      # (time, seq, kind, tid)
        self._seq = 0
        self._last_mode_stamp = 0.0
        # hot-loop caches: per-task program / LO-crit flag resolved once
        # instead of two dict hops per dispatch (+ per mode tick)
        self._progs: Dict[int, Program] = {
            t.tid: programs[t.workload] for t in tasks}
        self._is_lo: Dict[int, bool] = {
            t.tid: t.crit == Crit.LO for t in tasks}
        self._t_sr = policy.t_sr
        self._instr_preempt = policy.preemption == "instruction"
        self._use_banks = policy.use_banks
        self._note_execution = self.accel.note_execution

    # ------------------------------------------------------------------
    def _push(self, t: float, kind: int, tid: int = -1):
        self._seq += 1
        heappush(self._events, (t, self._seq, kind, tid))

    def _program(self, tid: int) -> Program:
        return self._progs[tid]

    def _next_tick(self, t: float) -> float:
        k = int(t // self._t_sr) + 1
        return k * self._t_sr

    # ------------------------------------------------------------------
    def _advance_running(self):
        """Account progress of the running task up to self.now."""
        if self.running is None:
            return
        tcb = self.tcbs[self.running]
        elapsed = self.now - self._run_started
        if elapsed <= 0:
            return
        tcb.exec_cycles += elapsed
        self.metrics.exec_cycles += elapsed
        self._note_execution(tcb.tid, elapsed, self._progs[tcb.tid])
        self._run_started = self.now

    def _set_mode(self, mode: Mode):
        if mode is not self.mode:
            self.metrics.mode_cycles[self.mode.value] += \
                self.now - self._last_mode_stamp
            self._last_mode_stamp = self.now
            self.mode = mode

    def _mode_tick(self):
        """Mode progression per SS IV."""
        if self.mode is Mode.LO:
            return                   # LO only leaves via an overrun event
        is_lo = self._is_lo
        resident_lo = [t for t in self.accel.remapper.resident_tasks()
                       if is_lo.get(t)]
        any_active = any(t.status is not Status.PENDING
                         for t in self.tcbs.values())
        if self.mode == Mode.TRANS and len(resident_lo) <= 1:
            self._set_mode(Mode.HI)
        elif self.mode != Mode.LO and not any_active:
            self._set_mode(Mode.LO)

    # ------------------------------------------------------------------
    def _finish_job(self, tcb: TCB):
        tcb.status = Status.PENDING
        crit = tcb.params.crit.value
        self.metrics.done[crit] += 1
        if tcb.job_release >= 0 and self.now > tcb.job_deadline:
            self.metrics.misses[crit] += 1
            self.metrics.misses_by_mode[self.mode.value] += 1
        if tcb.released_in_hi and self.now <= tcb.job_deadline:
            self.metrics.lo_done_in_hi += 1
        self.metrics.overhead_cycles += self.accel.evict(tcb.tid)
        tcb.data_in_accel = False
        self.demand.pop(tcb.tid, None)

    def _record_unblock(self, tcb: TCB, at: Optional[float] = None):
        if tcb.blocked_since is not None:
            dt = (at if at is not None else self.now) - tcb.blocked_since
            # criticality inversion: a HI-task was kept waiting by a LO-task
            # while the system was (or entered) degraded mode
            cause = tcb.blocking_cause
            if (cause == "ci?" and self.mode != Mode.LO):
                cause = "ci"
            if dt > 0:
                (self.metrics.ci_blocking if cause == "ci"
                 else self.metrics.pi_blocking).append(dt)
            tcb.blocked_since = None
            tcb.blocking_cause = None

    def _mark_blocked(self, tcb: TCB):
        if tcb.blocked_since is None:
            tcb.blocked_since = self.now
            run = self.tcbs.get(self.running) if self.running is not None \
                else None
            if (tcb.params.crit == Crit.HI and run is not None
                    and run.params.crit == Crit.LO):
                tcb.blocking_cause = "ci" if self.mode != Mode.LO else "ci?"
            else:
                tcb.blocking_cause = "pi"

    # ------------------------------------------------------------------
    def _dispatch(self, nxt: TCB):
        """Context switch to ``nxt`` (Alg. 1)."""
        cur = self.tcbs.get(self.running) if self.running is not None else None
        switch_cost = 0.0
        if cur is not None and cur.tid != nxt.tid:
            prog = self._progs[cur.tid]
            if self._instr_preempt:
                boundary = prog.next_instruction_boundary(cur.exec_cycles)
            else:  # operator
                boundary = prog.next_operator_boundary(cur.exec_cycles)
            drain = max(0.0, min(boundary, self.demand[cur.tid])
                        - cur.exec_cycles)
            cur.exec_cycles += drain
            next_eta = nxt.params.eta if self._use_banks else None
            br = self.accel.context_save(cur, int(drain), next_eta=next_eta)
            # HI-mode rule: <=1 resident LO-task -> evict on LO->LO preempt
            if (self.mode == Mode.HI and cur.params.crit == Crit.LO
                    and nxt.params.crit == Crit.LO):
                self.accel.remapper.release(cur.tid)
                cur.data_in_accel = False
            cur.status = Status.INTERRUPTED
            switch_cost += br.total
            self.metrics.save_cycles.append(br.total)
            self.metrics.cs_count += 1
        if nxt.pc > 0 or nxt.status == Status.INTERRUPTED:
            br = self.accel.context_restore(nxt)
            switch_cost += br.total
            self.metrics.restore_cycles.append(br.total)
        self.metrics.overhead_cycles += switch_cost
        self.running = nxt.tid
        nxt.status = Status.RUNNING
        nxt.pc = 1
        self._record_unblock(nxt, at=self.now + switch_cost)
        self._run_started = self.now + switch_cost
        self.accel_free_at = self.now + switch_cost
        # future events for the new running task
        rem = self.demand[nxt.tid] - nxt.exec_cycles
        self._push(self._run_started + rem, _FINISH, nxt.tid)
        p = nxt.params
        if (p.crit == Crit.HI and not nxt.budget_overrun
                and nxt.exec_cycles < p.c_lo):
            self._push(self._run_started + (p.c_lo - nxt.exec_cycles),
                       _OVERRUN, nxt.tid)

    def _schedule(self):
        """One scheduler invocation (a T_sr tick or an interrupt)."""
        if self.now < self.accel_free_at:      # CS in progress
            self._push(self._next_tick(self.accel_free_at), _TICK)
            return
        self._advance_running()
        self._mode_tick()
        # pick_next only consults residency in transition mode (the
        # "LO may run while not yet saved" rule) — skip the query otherwise
        resident = self.accel.remapper.resident_tasks() \
            if self.mode is Mode.TRANS else ()
        nxt = pick_next(self.tcbs, self.mode, resident, self.policy)
        cur = self.tcbs.get(self.running) if self.running is not None else None
        if cur is not None and cur.status != Status.RUNNING:
            cur = None
            self.running = None
        if nxt is None:
            return
        if cur is not None and nxt.tid == cur.tid:
            return
        if cur is not None and self.policy.preemption == "none":
            self._mark_blocked(nxt)            # must wait for completion
            return
        if cur is not None:
            self._mark_blocked(nxt)            # waits for drain + CS
        self._dispatch(nxt)

    # ------------------------------------------------------------------
    def run(self) -> RunMetrics:
        for tid, p in self.params.items():
            phase = self.rng.uniform(0, p.period)
            self._push(self.sampler.shift_phase(tid, phase, p.period),
                       _RELEASE, tid)
        self._run_started = 0.0
        events = self._events
        heappop = heapq.heappop
        tcbs = self.tcbs
        duration = self.duration
        while events:
            t, _, kind, tid = heappop(events)
            if t > duration:
                break
            self.now = t
            if kind == _TICK:
                self._schedule()
            elif kind == _FINISH:
                tcb = tcbs[tid]
                if self.running == tid and tcb.status == Status.RUNNING:
                    self._advance_running()
                    if tcb.exec_cycles >= self.demand.get(
                            tid, float("inf")) - 1e-6:
                        self._finish_job(tcb)
                        self.running = None
                        self._schedule()
            elif kind == _RELEASE:
                tcb = tcbs[tid]
                p = tcb.params
                rel_n = self.sampler.count_release(tid)
                self._seq += 1
                heappush(events, (t + p.period, self._seq, _RELEASE, tid))
                if tcb.status != Status.PENDING:
                    # previous job still live: count a miss once, skip release
                    if tcb.job_deadline != float("inf"):
                        self.metrics.misses[p.crit.value] += 1
                        self.metrics.misses_by_mode[self.mode.value] += 1
                        tcb.job_deadline = float("inf")
                    continue
                if self.policy.drop_lo_in_hi and p.crit == Crit.LO \
                        and self.mode != Mode.LO:
                    continue                    # AMC: LO not released
                tcb.release(t)
                self.demand[tid] = self.sampler.sample(p, rel_n, t)
                self.metrics.jobs[p.crit.value] += 1
                tcb.released_in_hi = (p.crit == Crit.LO
                                      and self.mode != Mode.LO)
                if tcb.released_in_hi:
                    self.metrics.lo_released_in_hi += 1
                self._seq += 1
                heappush(events,
                         (self._next_tick(t), self._seq, _TICK, -1))
            else:                               # _OVERRUN
                tcb = tcbs[tid]
                if self.running == tid and tcb.status == Status.RUNNING:
                    self._advance_running()
                    if tcb.exec_cycles >= tcb.params.c_lo - 1e-6 \
                            and not tcb.budget_overrun:
                        tcb.budget_overrun = True
                        if self.mode == Mode.LO:
                            self._set_mode(Mode.TRANS)   # Mode_switch
                        self._schedule()
        # tail accounting
        self.metrics.mode_cycles[self.mode.value] += \
            self.duration - self._last_mode_stamp
        for tcb in self.tcbs.values():
            if tcb.status != Status.PENDING \
                    and self.duration > tcb.job_deadline:
                self.metrics.misses[tcb.params.crit.value] += 1
        return self.metrics


def simulate(tasks, programs, policy, **kw) -> RunMetrics:
    return MCSSimulator(tasks, programs, policy, **kw).run()


# ======================================================================
# Multi-accelerator partitioned simulation (platform layer)
# ======================================================================

@dataclasses.dataclass
class MultiRunMetrics:
    """Per-instance RunMetrics plus the platform-global counters."""
    per_instance: List[RunMetrics]
    migrations: int = 0
    migration_cycles: float = 0.0
    dma_contention_cycles: float = 0.0

    @property
    def n_instances(self) -> int:
        return len(self.per_instance)

    def merged(self) -> RunMetrics:
        """Sum the per-instance metrics into one platform-wide view."""
        out = RunMetrics()
        for m in self.per_instance:
            out.pi_blocking += m.pi_blocking
            out.ci_blocking += m.ci_blocking
            out.save_cycles += m.save_cycles
            out.restore_cycles += m.restore_cycles
            for k in out.jobs:
                out.jobs[k] += m.jobs[k]
                out.done[k] += m.done[k]
                out.misses[k] += m.misses[k]
            for k in out.misses_by_mode:
                out.misses_by_mode[k] += m.misses_by_mode[k]
            for k in out.mode_cycles:
                out.mode_cycles[k] += m.mode_cycles[k]
            out.lo_released_in_hi += m.lo_released_in_hi
            out.lo_done_in_hi += m.lo_done_in_hi
            out.cs_count += m.cs_count
            out.exec_cycles += m.exec_cycles
            # migration + DMA-contention cycles are already part of the
            # per-instance overhead (charged at dispatch time); the
            # standalone counters below just break them out
            out.overhead_cycles += m.overhead_cycles
        return out

    def success(self, scope: str = "all") -> bool:
        return self.merged().success(scope)

    def survivability(self) -> float:
        return self.merged().survivability()


@dataclasses.dataclass
class _InstState:
    """Mutable per-instance runtime state of the multi-accel loop."""
    running: Optional[int] = None
    accel_free_at: float = 0.0
    run_started: float = 0.0
    last_mode_stamp: float = 0.0
    metrics: RunMetrics = dataclasses.field(default_factory=RunMetrics)


class MultiAccelSimulator:
    """Partitioned MESC over N virtual Gemmini^RT instances.

    Tasks are statically partitioned onto instances
    (``core.platform.partition``); each instance runs the single-
    accelerator MESC semantics — its own SS IV mode machine, bank
    remapper and preemption policy — under one global event clock.  Two
    cross-instance couplings make N instances more than N independent
    simulators:

      * **shared DMA**: all instances save/restore context over one
        DRAM path, so a context switch that overlaps ``k`` concurrent
        switches on other instances is stretched ``(1+k)x`` (equal
        bandwidth share), the extra cycles accounted in
        ``dma_contention_cycles``;
      * **LO migration-on-idle**: an instance that goes idle in LO-mode
        pulls the highest-priority waiting LO-task from a busy
        instance, paying the context-shipping DMA cost
        (``platform.MigrationPolicy``).

    ``n_instances=1`` degenerates to the single-accelerator semantics
    of :class:`MCSSimulator` — same rng contract, same event order, so
    identical metrics (pinned by ``tests/test_platform.py::
    TestMultiAccelSimulator::test_single_instance_matches_single_simulator``).
    """

    def __init__(self, tasks: List[TaskParams], programs: Dict[str, Program],
                 policy: Policy, *, n_instances: int = 2,
                 heuristic: str = "crit_aware",
                 duration: float = 2e7, seed: int = 0,
                 overrun_prob: float = 0.3, cf: float = 2.0,
                 dma_contention: bool = True,
                 migration=None, demand_profile: str = "sampled",
                 scenario=None):
        from repro_torch.core.platform import AcceleratorPool, MigrationPolicy
        self.params = {t.tid: t for t in tasks}
        self.programs = programs
        self.policy = policy
        self.duration = duration
        self.rng = np.random.default_rng(seed)
        self.overrun_prob = overrun_prob
        self.cf = cf
        self.sampler = DemandSampler(
            self.rng, tasks, seed=seed, overrun_prob=overrun_prob, cf=cf,
            demand_profile=demand_profile, scenario=scenario)
        self.dma_contention = dma_contention
        self.pool = AcceleratorPool(
            n_instances, use_remapper=policy.use_banks, heuristic=heuristic,
            migration=migration or MigrationPolicy())
        self.assignment = self.pool.assign(tasks)
        from repro_torch.core.scheduler import ModeCoordinator
        self.coordinator = ModeCoordinator(n_instances)
        self.tcbs: Dict[int, TCB] = {t.tid: TCB(params=t) for t in tasks}
        self.insts = [_InstState() for _ in range(n_instances)]
        self.multi = MultiRunMetrics(
            per_instance=[s.metrics for s in self.insts])
        self.now = 0.0
        self.demand: Dict[int, float] = {}
        self._events: List = []      # (time, seq, kind, tid-or-inst)
        self._seq = 0
        self._last_migration: Dict[int, float] = {}
        self._migration_retry_at: Optional[float] = None
        self._progs: Dict[int, Program] = {
            t.tid: programs[t.workload] for t in tasks}

    # ------------------------------------------------------------------
    def _push(self, t: float, kind: int, key: int = -1):
        self._seq += 1
        heapq.heappush(self._events, (t, self._seq, kind, key))

    def _program(self, tid: int) -> Program:
        return self._progs[tid]

    def _next_tick(self, t: float) -> float:
        return (int(t // self.policy.t_sr) + 1) * self.policy.t_sr

    def _inst_of(self, tid: int) -> int:
        return self.assignment.instance_of(tid)

    def _inst_tcbs(self, inst: int) -> Dict[int, TCB]:
        return {tid: tcb for tid, tcb in self.tcbs.items()
                if self._inst_of(tid) == inst}

    # ------------------------------------------------------------------
    def _advance_running(self, inst: int):
        st = self.insts[inst]
        if st.running is None:
            return
        tcb = self.tcbs[st.running]
        elapsed = self.now - st.run_started
        if elapsed <= 0:
            return
        tcb.exec_cycles += elapsed
        st.metrics.exec_cycles += elapsed
        self.pool.instances[inst].note_execution(
            tcb.tid, elapsed, self._program(tcb.tid))
        st.run_started = self.now

    def _set_mode(self, inst: int, mode: Mode):
        st = self.insts[inst]
        cur = self.coordinator.mode_of(inst)
        if mode is not cur:
            st.metrics.mode_cycles[cur.value] += \
                self.now - st.last_mode_stamp
            st.last_mode_stamp = self.now
            self.coordinator.set_mode(inst, mode)

    def _mode_tick(self, inst: int) -> Dict[int, TCB]:
        """Run the instance's SS IV progression; returns the instance's
        TCB view so the caller's scheduling pass can reuse it."""
        tcbs = self._inst_tcbs(inst)
        if self.coordinator.mode_of(inst) is Mode.LO:
            return tcbs              # LO only leaves via an overrun event
        accel = self.pool.instances[inst]
        resident_lo = [t for t in accel.remapper.resident_tasks()
                       if self.params.get(t) is not None
                       and self.params[t].crit == Crit.LO]
        any_active = any(t.status in ACTIVE for t in tcbs.values())
        # one shared copy of the SS IV progression (scheduler.update_mode)
        self._set_mode(inst, update_mode(self.coordinator.mode_of(inst),
                                         tcbs, resident_lo, any_active))
        return tcbs

    # ------------------------------------------------------------------
    def _finish_job(self, inst: int, tcb: TCB):
        st = self.insts[inst]
        tcb.status = Status.PENDING
        crit = tcb.params.crit.value
        st.metrics.done[crit] += 1
        if tcb.job_release >= 0 and self.now > tcb.job_deadline:
            st.metrics.misses[crit] += 1
            st.metrics.misses_by_mode[
                self.coordinator.mode_of(inst).value] += 1
        if tcb.released_in_hi and self.now <= tcb.job_deadline:
            st.metrics.lo_done_in_hi += 1
        st.metrics.overhead_cycles += self.pool.instances[inst].evict(tcb.tid)
        tcb.data_in_accel = False
        self.demand.pop(tcb.tid, None)
        # job-scoped migration: the context is discarded with the job,
        # so the task snaps back to its static partition for free
        if self.assignment.instance_of(tcb.tid) \
                != self.assignment.home_of(tcb.tid):
            self.assignment.return_home(tcb.tid)

    def _record_unblock(self, inst: int, tcb: TCB,
                        at: Optional[float] = None):
        st = self.insts[inst]
        if tcb.blocked_since is not None:
            dt = (at if at is not None else self.now) - tcb.blocked_since
            cause = tcb.blocking_cause
            if cause == "ci?" and self.coordinator.mode_of(inst) != Mode.LO:
                cause = "ci"
            if dt > 0:
                (st.metrics.ci_blocking if cause == "ci"
                 else st.metrics.pi_blocking).append(dt)
            tcb.blocked_since = None
            tcb.blocking_cause = None

    def _mark_blocked(self, inst: int, tcb: TCB):
        st = self.insts[inst]
        if tcb.blocked_since is None:
            tcb.blocked_since = self.now
            run = self.tcbs.get(st.running) if st.running is not None else None
            if (tcb.params.crit == Crit.HI and run is not None
                    and run.params.crit == Crit.LO):
                cause = "ci" if self.coordinator.mode_of(inst) != Mode.LO \
                    else "ci?"
                tcb.blocking_cause = cause
            else:
                tcb.blocking_cause = "pi"

    # ------------------------------------------------------------------
    def _concurrent_switches(self, inst: int) -> int:
        """Instances other than ``inst`` mid-context-switch right now —
        they hold a share of the single DMA path."""
        return sum(1 for i, st in enumerate(self.insts)
                   if i != inst and st.accel_free_at > self.now)

    def _dispatch(self, inst: int, nxt: TCB, extra_cost: float = 0.0):
        """Context switch on one instance (Alg. 1) with shared-DMA
        contention stretching and optional migration cycles."""
        st = self.insts[inst]
        accel = self.pool.instances[inst]
        cur = self.tcbs.get(st.running) if st.running is not None else None
        switch_cost = extra_cost
        if cur is not None and cur.tid != nxt.tid:
            prog = self._program(cur.tid)
            if self.policy.preemption == "instruction":
                boundary = prog.next_instruction_boundary(cur.exec_cycles)
            else:
                boundary = prog.next_operator_boundary(cur.exec_cycles)
            drain = max(0.0, min(boundary, self.demand[cur.tid])
                        - cur.exec_cycles)
            cur.exec_cycles += drain
            next_eta = nxt.params.eta if self.policy.use_banks else None
            br = accel.context_save(cur, int(drain), next_eta=next_eta)
            if (self.coordinator.mode_of(inst) == Mode.HI
                    and cur.params.crit == Crit.LO
                    and nxt.params.crit == Crit.LO):
                accel.remapper.release(cur.tid)
                cur.data_in_accel = False
            cur.status = Status.INTERRUPTED
            switch_cost += br.total
            st.metrics.save_cycles.append(br.total)
            st.metrics.cs_count += 1
        if nxt.pc > 0 or nxt.status == Status.INTERRUPTED:
            br = accel.context_restore(nxt)
            switch_cost += br.total
            st.metrics.restore_cycles.append(br.total)
        if self.dma_contention and switch_cost > 0:
            stretch = switch_cost * self._concurrent_switches(inst)
            switch_cost += stretch
            self.multi.dma_contention_cycles += stretch
        st.metrics.overhead_cycles += switch_cost
        st.running = nxt.tid
        nxt.status = Status.RUNNING
        nxt.pc = 1
        self._record_unblock(inst, nxt, at=self.now + switch_cost)
        st.run_started = self.now + switch_cost
        st.accel_free_at = self.now + switch_cost
        rem = self.demand[nxt.tid] - nxt.exec_cycles
        self._push(st.run_started + rem, _FINISH, nxt.tid)
        p = nxt.params
        if (p.crit == Crit.HI and not nxt.budget_overrun
                and nxt.exec_cycles < p.c_lo):
            self._push(st.run_started + (p.c_lo - nxt.exec_cycles),
                       _OVERRUN, nxt.tid)

    def _try_migrate_to(self, inst: int):
        """Pull the highest-priority waiting LO-task from a busy
        instance onto idle instance ``inst`` (migration-on-idle).
        Returns ``(tcb, ship_cycles)`` or ``None``; a candidate
        rejected only on timing grounds (min_wait / cooldown) leaves a
        retry time in ``self._migration_retry_at`` so the idle
        instance re-checks instead of sleeping past the window."""
        self._migration_retry_at = None
        mig = self.pool.migration
        if not mig.enabled:
            return None
        if mig.lo_mode_only \
                and self.coordinator.mode_of(inst) != Mode.LO:
            return None
        candidates = []
        retry_at = None
        for tid, tcb in self.tcbs.items():
            home = self._inst_of(tid)
            if home == inst or tcb.params.crit != Crit.LO:
                continue
            if tcb.status not in (Status.READY, Status.INTERRUPTED):
                continue
            if self.insts[home].running == tid:
                continue
            if self.insts[home].running is None:
                continue        # home instance is idle: it will run it
            eligible_at = max(
                tcb.job_release + mig.min_wait,
                self._last_migration.get(tid, -1e18) + mig.cooldown)
            if self.now < eligible_at:
                retry_at = eligible_at if retry_at is None \
                    else min(retry_at, eligible_at)
                continue        # home may pick it up sooner; re-check
            candidates.append(tcb)
        if mig.hi_slack_guard and candidates:
            from repro_torch.core.isa import (ACCUM_BYTES, BANK_BYTES,
                                              DMA_BYTES_PER_CYCLE)
            stretch = self.pool.n_instances if self.dma_contention else 1
            hi_params = [t.params for t in self._inst_tcbs(inst).values()
                         if t.params.crit == Crit.HI]

            def preempt_cost(c: TCB) -> float:
                # worst case to get the migrant out of a HI-task's way:
                # the HI release can land mid-restore (ship + mvin, the
                # switch is atomic), then drain one instruction and
                # save the full working set (eta banks + accumulator)
                # back out — 4 full-working-set DMA passes, every cycle
                # stretched by full cross-instance contention
                bytes_wc = c.params.eta * BANK_BYTES + ACCUM_BYTES
                return (self._program(c.tid).max_instruction_cycles
                        + stretch * 4.0 * bytes_wc / DMA_BYTES_PER_CYCLE)

            candidates = [
                c for c in candidates
                if all(h.deadline - h.c_hi
                       > mig.slack_margin * preempt_cost(c)
                       for h in hi_params)]
        if not candidates:
            # timing-rejected tasks may become eligible later even when
            # the slack guard emptied the list — keep the retry time
            self._migration_retry_at = retry_at
            return None
        best = min(candidates, key=lambda t: t.params.priority)
        self._last_migration[best.tid] = self.now
        cycles = self.pool.migrate(best.tid, inst)
        self.multi.migrations = self.pool.migrations
        self.multi.migration_cycles += cycles
        return best, cycles

    def _schedule(self, inst: int):
        st = self.insts[inst]
        if self.now < st.accel_free_at:       # CS in progress
            self._push(self._next_tick(st.accel_free_at), _TICK, inst)
            return
        self._advance_running(inst)
        tcbs = self._mode_tick(inst)
        accel = self.pool.instances[inst]
        mode = self.coordinator.mode_of(inst)
        resident = accel.remapper.resident_tasks() \
            if mode is Mode.TRANS else ()
        nxt = pick_next(tcbs, mode, resident, self.policy)
        cur = self.tcbs.get(st.running) if st.running is not None else None
        if cur is not None and cur.status != Status.RUNNING:
            cur = None
            st.running = None
        if nxt is None and cur is None:
            migrated = self._try_migrate_to(inst)
            if migrated is not None:
                tcb, ship_cycles = migrated
                self._dispatch(inst, tcb, extra_cost=ship_cycles)
            elif self._migration_retry_at is not None:
                # a candidate becomes timing-eligible later: re-check
                # then instead of sleeping until this instance's next
                # own release
                self._push(self._next_tick(self._migration_retry_at),
                           _TICK, inst)
            return
        if nxt is None:
            return
        if cur is not None and nxt.tid == cur.tid:
            return
        if cur is not None and self.policy.preemption == "none":
            self._mark_blocked(inst, nxt)
            return
        if cur is not None:
            self._mark_blocked(inst, nxt)
        self._dispatch(inst, nxt)

    # ------------------------------------------------------------------
    def run(self) -> MultiRunMetrics:
        for tid, p in self.params.items():
            phase = self.rng.uniform(0, p.period)
            self._push(self.sampler.shift_phase(tid, phase, p.period),
                       _RELEASE, tid)
        while self._events:
            t, _, kind, key = heapq.heappop(self._events)
            if t > self.duration:
                break
            self.now = t
            if kind == _RELEASE:
                tid = key
                inst = self._inst_of(tid)
                st = self.insts[inst]
                tcb = self.tcbs[tid]
                p = tcb.params
                rel_n = self.sampler.count_release(tid)
                self._push(t + p.period, _RELEASE, tid)
                if tcb.status != Status.PENDING:
                    if tcb.job_deadline != float("inf"):
                        st.metrics.misses[p.crit.value] += 1
                        st.metrics.misses_by_mode[
                            self.coordinator.mode_of(inst).value] += 1
                        tcb.job_deadline = float("inf")
                    continue
                mode = self.coordinator.mode_of(inst)
                if self.policy.drop_lo_in_hi and p.crit == Crit.LO \
                        and mode != Mode.LO:
                    continue
                tcb.release(t)
                self.demand[tid] = self.sampler.sample(p, rel_n, t)
                st.metrics.jobs[p.crit.value] += 1
                tcb.released_in_hi = (p.crit == Crit.LO and mode != Mode.LO)
                if tcb.released_in_hi:
                    st.metrics.lo_released_in_hi += 1
                self._push(self._next_tick(t), _TICK, inst)
                # wake idle instances: their scheduler pass may pull
                # this (or another waiting) LO-task via migration-on-
                # idle — without this an instance whose own partition
                # is quiet never re-checks
                for other, ost in enumerate(self.insts):
                    if other != inst and ost.running is None:
                        self._push(self._next_tick(t), _TICK, other)
            elif kind == _FINISH:
                tid = key
                inst = self._inst_of(tid)
                st = self.insts[inst]
                tcb = self.tcbs[tid]
                if st.running == tid and tcb.status == Status.RUNNING:
                    self._advance_running(inst)
                    if tcb.exec_cycles >= self.demand.get(
                            tid, float("inf")) - 1e-6:
                        self._finish_job(inst, tcb)
                        st.running = None
                        self._schedule(inst)
            elif kind == _OVERRUN:
                tid = key
                inst = self._inst_of(tid)
                st = self.insts[inst]
                tcb = self.tcbs[tid]
                if st.running == tid and tcb.status == Status.RUNNING:
                    self._advance_running(inst)
                    if tcb.exec_cycles >= tcb.params.c_lo - 1e-6 \
                            and not tcb.budget_overrun:
                        tcb.budget_overrun = True
                        if self.coordinator.mode_of(inst) == Mode.LO:
                            self._set_mode(inst, Mode.TRANS)
                        self._schedule(inst)
            elif kind == _TICK:
                self._schedule(key)
        # tail accounting
        for inst, st in enumerate(self.insts):
            st.metrics.mode_cycles[
                self.coordinator.mode_of(inst).value] += \
                self.duration - st.last_mode_stamp
        for tcb in self.tcbs.values():
            if tcb.status != Status.PENDING \
                    and self.duration > tcb.job_deadline:
                inst = self._inst_of(tcb.tid)
                self.insts[inst].metrics.misses[tcb.params.crit.value] += 1
        return self.multi


def simulate_multi(tasks, programs, policy, **kw) -> MultiRunMetrics:
    """One partitioned multi-accelerator run (platform layer)."""
    return MultiAccelSimulator(tasks, programs, policy, **kw).run()


def simulate_batch(tasksets, programs, policy, *, seeds,
                   **kw) -> List[RunMetrics]:
    """Batch entry point: one independent simulator per (taskset, seed).

    ``seeds`` must align with ``tasksets``; pair this with
    ``taskgen.generate_taskset_batch`` so taskset ``s`` and its run share
    ``point_seed(seed0, s)`` — the engine's per-point seeding contract.
    """
    if len(tasksets) != len(seeds):
        raise ValueError(f"{len(tasksets)} tasksets vs {len(seeds)} seeds")
    return [MCSSimulator(tasks, programs, policy, seed=s, **kw).run()
            for tasks, s in zip(tasksets, seeds)]
