"""Vectorized struct-of-arrays batch simulation backend (own copy of the
reference's ``core/simulator_vec.py``).

``simulate_vbatch`` advances **hundreds of independent (taskset, seed)
points per vectorized step** instead of running one Python event loop
per point.  Every piece of per-point simulator state lives in a NumPy
array indexed ``[point]`` or ``[point, task]``, and each lockstep
iteration pops *each live point's next event* with one ``argmin`` over
a candidate-time matrix, then applies the event handlers as masked
array updates.  This is host code; it uses no torch.

Exactness contract
------------------
The engine is a *semantics-preserving* reimplementation of
:class:`repro_torch.core.simulator.MCSSimulator`, not an approximation:

  * the event-queue is replaced by derived candidate times (per-task
    next release, pending scheduler ticks) plus a small per-point table
    of pending finish/overrun interrupts.  The table is a *multiset*:
    the event engine's stale heap entries — finish/overrun events left
    behind by preemptions — still call ``_advance_running`` when their
    task happens to be running again, checkpointing execution (and the
    integer-floored residency growth of ``note_execution``) at that
    timestamp.  The vectorized engine replays exactly those firings;
  * every float operation (demand sampling, drain/boundary arithmetic,
    blocking intervals, mode residency stamps) is performed in the same
    order with the same IEEE-754 double ops, and every cycle-cost
    quantity is the same integer arithmetic as ``GemminiRT``;
  * each point owns its own ``np.random.default_rng(seed)`` and draws
    are consumed in the same order (phases at init, demand per accepted
    release), so the two engines see identical randomness.

Result: per-run metrics match the event engine's bit for bit on every
point, and the reference's vec engine's.  The only *permitted*
deviation class is sub-tick event interleaving at exactly-equal event
timestamps (probability ~0 under the continuous phase/demand draws).

The port's lockstep engine (``core.simulator_jit``) starts from the same
batch: it reads ``_VecBatch.__init__``'s static per-task tables and
release phases and ``_build_boundary_tables``'s keyed program tables.
The NumPy engine's dynamic state is built by ``_VecBatch._init_state``
when ``run`` starts, so the lockstep engine never allocates it.

``select_backend="jit"`` routes the whole batch to that engine:
statistically equivalent under demand jitter, exactly equivalent on
``demand_profile="nominal"``, with its own cache salt.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.isa import (ACCUM_BYTES, BANK_BYTES, CONFIG_CYCLES,
                                  DMA_BYTES_PER_CYCLE, DMA_SETUP_CYCLES,
                                  FLUSH_CYCLES, FREEZE_CYCLES,
                                  REMAP_BLOCK_BYTES, SCRATCHPAD_BANKS)
from repro_torch.core.program import Program
from repro_torch.core.scheduler import Policy
from repro_torch.core.simulator import DEMAND_PROFILES, RunMetrics
from repro_torch.core.task import Crit, TaskParams
from repro_torch.scenarios import (demand_multiplier, get_scenario,
                                   shifted_phases)

# Cache-key salts of the reference's engines, kept equal so that a row
# of the port and a row of the reference name the same semantics.
VEC_SIM_SEMANTICS_VERSION = 1
JIT_SIM_SEMANTICS_VERSION = 3

# status codes (mirror task.Status)
_PEND, _READY, _RUN, _INT = 0, 1, 2, 3
# mode codes (column order of the mode-indexed metric arrays)
_LO, _TRANS, _HI = 0, 1, 2
_MODE_KEYS = ("LO", "transition", "HI")
# blocking causes
_C_NONE, _C_PI, _C_CIQ, _C_CI = 0, 1, 2, 3

_CRIT_KEYS = ("LO", "HI")
_PID_KEY = 2 ** 40          # per-program key offset for the global tables
_EMPTY = 2 ** 62            # "no eligible task" sentinel for min-keys
_BB = BANK_BYTES
_NBANKS = SCRATCHPAD_BANKS
_CAP = _BB * _NBANKS
_FF = FREEZE_CYCLES + FLUSH_CYCLES
_CFG_CY = DMA_SETUP_CYCLES + 4 * CONFIG_CYCLES
_REMAP_CY = DMA_SETUP_CYCLES + \
    -(-REMAP_BLOCK_BYTES // DMA_BYTES_PER_CYCLE)          # = _dma(4096)
_RESTORE_FIXED = _CFG_CY + 4 * CONFIG_CYCLES + 2 * 2      # config+reconfig+resend


def _dma_vec(nbytes: np.ndarray) -> np.ndarray:
    """Vectorized executor._dma_cycles (exact integer arithmetic;
    callers pass int64 arrays)."""
    cy = DMA_SETUP_CYCLES + (nbytes + DMA_BYTES_PER_CYCLE - 1) \
        // DMA_BYTES_PER_CYCLE
    return np.where(nbytes <= 0, 0, cy)


# ----------------------------------------------------------------------
# Program table: per-program constant arrays for the boundary queries
# ----------------------------------------------------------------------

class _VecProgram:
    """Per-program constant tables (segment ends/cycles, pattern
    cumsums, operator ends, eta banks) consumed by
    ``_VecBatch._build_boundary_tables`` for the vectorized
    next_{instruction,operator}_boundary queries."""

    def __init__(self, prog: Program):
        self.total = prog._total
        self.seg_ends = prog._seg_ends                     # int64, cumsum
        self.seg_cycles = np.asarray(prog._seg_cycles, dtype=np.int64)
        self.seg_pat = np.asarray(prog._seg_pattern_cycles, dtype=np.int64)
        self.op_ends = prog._operator_ends
        maxlen = max(len(s.pattern_costs) for s in prog.segments)
        pc = np.full((len(prog.segments), maxlen), np.iinfo(np.int64).max,
                     dtype=np.int64)
        for i, s in enumerate(prog.segments):
            pc[i, :len(s.pattern_costs)] = np.cumsum(s.pattern_costs)
        self.pat_cumsum = pc
        # executor.note_execution's eta-bank count for this program
        self.eta_banks = max(
            1, -(-min(prog.working_set_bytes, _CAP) // _BB))


# valid simulate_vbatch backends ("jax" is a deprecated alias of "jit")
BACKENDS = ("numpy", "jit", "jax")


# ----------------------------------------------------------------------
# The batch
# ----------------------------------------------------------------------

class _VecBatch:
    """SoA state + lockstep event loop for one batch of points that
    share (policy, duration, overrun_prob, cf).  ``__init__`` builds the
    static tables and draws the release phases (what the lockstep engine
    reads); ``run`` adds the dynamic state and steps the batch."""

    def __init__(self, tasksets: Sequence[List[TaskParams]],
                 programs: Dict[str, Program], policy: Policy, *,
                 seeds: Sequence[int], duration: float,
                 overrun_prob: float, cf: float,
                 demand_profile: str = "sampled", scenario=None):
        P = len(tasksets)
        T = max(len(ts) for ts in tasksets)
        self.P, self.T = P, T
        self.policy = policy
        self.duration = float(duration)
        self.overrun_prob = overrun_prob
        self.cf = cf
        self.t_sr = policy.t_sr
        self.use_banks = policy.use_banks
        self.drop_lo = policy.drop_lo_in_hi
        self.preempt = policy.preemption           # instruction|operator|none
        self.demand_profile = demand_profile
        self.scen = get_scenario(scenario)

        # ---- program table ------------------------------------------------
        prog_ids: Dict[int, int] = {}
        self.vprogs: List[_VecProgram] = []

        def pid_of(prog: Program) -> int:
            k = id(prog)
            if k not in prog_ids:
                prog_ids[k] = len(self.vprogs)
                self.vprogs.append(_VecProgram(prog))
            return prog_ids[k]

        # ---- static per-task arrays --------------------------------------
        self.valid = np.zeros((P, T), bool)
        self.prio = np.full((P, T), np.iinfo(np.int64).max, np.int64)
        self.period = np.full((P, T), np.inf)
        self.deadline_rel = np.full((P, T), np.inf)
        self.c_lo = np.full((P, T), np.inf)
        self.is_hi = np.zeros((P, T), bool)
        self.eta = np.zeros((P, T), np.int64)
        self.prog_id = np.zeros((P, T), np.int32)
        self.etab = np.ones((P, T), np.int64)      # note_execution eta banks
        for p, ts in enumerate(tasksets):
            for t, tp in enumerate(ts):
                prog = programs[tp.workload]
                self.valid[p, t] = True
                self.prio[p, t] = tp.priority
                self.period[p, t] = tp.period
                self.deadline_rel[p, t] = tp.deadline
                self.c_lo[p, t] = tp.c_lo
                self.is_hi[p, t] = tp.crit == Crit.HI
                self.eta[p, t] = tp.eta
                self.prog_id[p, t] = pid_of(prog)
                self.etab[p, t] = self.vprogs[self.prog_id[p, t]].eta_banks
        self._build_boundary_tables()

        # ---- rng + release phases (same draw order as the event engine) --
        self.rngs = [np.random.default_rng(int(s)) for s in seeds]
        self.seed64 = np.asarray(seeds, np.int64).astype(np.uint64)
        self.next_release = np.full((P, T), np.inf)
        scen = self.scen
        shift = scen is not None and scen.has_phase_shift
        for p, ts in enumerate(tasksets):
            rng = self.rngs[p]
            for t, tp in enumerate(ts):
                ph = rng.uniform(0, tp.period)
                if shift:
                    # same scalar path as the event engine's sampler
                    ph = float(shifted_phases(scen, self.seed64[p],
                                              np.uint64(t), ph, tp.period))
                self.next_release[p, t] = ph

    def _init_state(self):
        """The NumPy engine's dynamic state (the rest of the reference's
        ``_VecBatch.__init__``): per-task and per-point state, metrics
        and event logs, and the incremental pick_next aggregates.  It
        draws nothing, so the release phases that ``__init__`` drew stay
        the lockstep engine's too."""
        P, T = self.P, self.T
        # ---- dynamic per-task state --------------------------------------
        z = lambda dt: np.zeros((P, T), dt)
        self.status = z(np.int8)
        self.exec_cy = z(np.float64)
        self.demand = np.full((P, T), np.inf)
        self.job_release = z(np.float64)
        self.job_deadline = z(np.float64)
        self.budget_overrun = z(bool)
        self.data_in_accel = z(bool)
        self.pc = z(np.int8)
        self.blocked_since = np.full((P, T), np.nan)
        self.cause = z(np.int8)
        self.released_in_hi = z(bool)
        # scenario state: absolute release-event counter per (point,
        # task) — bumped on *every* release event (accepted, busy-
        # missed or AMC-dropped), so scenario CRN draws keyed on it are
        # identical across policies.  Unused (all-zero) with scen=None.
        self.scen_n = z(np.int64)
        # accelerator state
        self.r_bytes = z(np.int64)       # remapper residency (use_banks)
        self.spad = z(np.int64)          # explicit-addressing residency
        self.acc_bytes = z(np.int64)
        self.ctx_valid = z(bool)
        self.ctx_acc = z(np.int64)
        self.ctx_spad = z(np.int64)
        self.ctx_kept = z(bool)

        # ---- per-point state ---------------------------------------------
        self.now = np.zeros(P)
        self.mode = np.zeros(P, np.int8)
        self.running = np.full(P, -1, np.int32)
        self.accel_free_at = np.zeros(P)
        self.run_started = np.zeros(P)
        self.last_mode_stamp = np.zeros(P)
        self.tick_cs = np.full(P, np.inf)
        self.alive = np.ones(P, bool)
        self.tick_release = np.full((P, T), np.inf)
        self.orig = np.arange(P)         # original point index (compaction)
        # pending finish/overrun interrupts: a per-point multiset (the
        # event engine's heap entries, stale ones included — see the
        # module docstring).  Grown on demand by _push_events.
        self.K = 8
        self.ev_time = np.full((P, self.K), np.inf)
        self.ev_tid = np.full((P, self.K), -1, np.int32)
        self.ev_kind = np.zeros((P, self.K), np.int8)   # 1=finish 2=overrun
        # hierarchical candidate minima: per-point row-min caches keep
        # the lockstep argmin at (P, 4) instead of (P, 2T+K+1)
        self.tickR_min = np.full(P, np.inf)
        self.ev_min = np.full(P, np.inf)

        # ---- metrics ------------------------------------------------------
        self.jobs = np.zeros((P, 2), np.int64)       # [:,0]=LO [:,1]=HI
        self.done = np.zeros((P, 2), np.int64)
        self.misses = np.zeros((P, 2), np.int64)
        self.misses_by_mode = np.zeros((P, 3), np.int64)
        self.mode_cycles = np.zeros((P, 3))
        self.lo_rel_hi = np.zeros(P, np.int64)
        self.lo_done_hi = np.zeros(P, np.int64)
        self.cs_count = np.zeros(P, np.int64)
        self.exec_sum = np.zeros(P)
        self.overhead = np.zeros(P)
        # event logs: (orig point idx array, value array) per metric list
        self.log_save: List = []
        self.log_restore: List = []
        self.log_pi: List = []
        self.log_ci: List = []

        self.rands = [r.random for r in self.rngs]
        self.rel_min = self.next_release.min(axis=1)
        # incremental total-locked-banks per point (sum of ceil(r/bb));
        # every r_bytes mutation below keeps it in sync
        self.locked = np.zeros(P, np.int64)
        self._ar = np.arange(P)
        # incremental pick_next aggregates.  The active set changes only
        # at releases and finishes, so each point carries the min
        # (priority, column) key over its active tasks — and over its
        # active HI tasks — plus active/HI counts and the count of LO
        # tasks with resident banks (mode progression).  prio_key
        # lexicographically encodes (priority, column) so ties break on
        # the lowest column, matching the event engine's dict order.
        self.keypad = T + 1
        self.prio_key = np.minimum(self.prio, 2 ** 40) * self.keypad \
            + np.arange(T)
        self.act_cnt = np.zeros(P, np.int32)
        self.hi_cnt = np.zeros(P, np.int32)
        self.act_key = np.full(P, _EMPTY, np.int64)
        self.hi_key = np.full(P, _EMPTY, np.int64)
        self.res_lo_cnt = np.zeros(P, np.int32)

    def _build_boundary_tables(self):
        """Concatenate every program's segment/operator tables into one
        globally sorted keyed array (key = pid * 2**40 + cycle), so one
        ``searchsorted`` answers the preemption-boundary query for a
        mixed-program batch without a per-program loop.  All keyed
        values stay below 2**53, so float64 keys are exact."""
        KEY = float(_PID_KEY)
        seg_ends, seg_cycles, seg_pat, cums = [], [], [], []
        op_ends = []
        self._prog_total = np.array([vp.total for vp in self.vprogs],
                                    dtype=np.int64)
        maxlen = max(vp.pat_cumsum.shape[1] for vp in self.vprogs)
        self._g_op_lastkey = np.empty(len(self.vprogs))
        for pid, vp in enumerate(self.vprogs):
            seg_ends.append(vp.seg_ends + pid * KEY)
            seg_cycles.append(vp.seg_cycles)
            seg_pat.append(vp.seg_pat)
            pc = vp.pat_cumsum
            if pc.shape[1] < maxlen:
                pad = np.full((pc.shape[0], maxlen - pc.shape[1]),
                              np.iinfo(np.int64).max, np.int64)
                pc = np.hstack([pc, pad])
            cums.append(pc)
            op_ends.append(vp.op_ends + pid * KEY)
            self._g_op_lastkey[pid] = len(vp.op_ends)
        self._g_seg_key = np.concatenate(seg_ends).astype(float)
        self._g_seg_cycles = np.concatenate(seg_cycles)
        self._g_seg_pat = np.concatenate(seg_pat)
        self._g_pat_cumsum = np.vstack(cums)
        self._g_op_key = np.concatenate(op_ends).astype(float)
        self._g_op_end = np.concatenate(
            [vp.op_ends for vp in self.vprogs]).astype(np.int64)
        self._g_op_hi = np.cumsum(self._g_op_lastkey).astype(np.int64) - 1

    # ------------------------------------------------------------------
    _PT_ARRAYS = ("valid prio period deadline_rel c_lo is_hi eta prog_id "
                  "etab status exec_cy demand job_release job_deadline "
                  "budget_overrun data_in_accel pc blocked_since cause "
                  "released_in_hi r_bytes spad acc_bytes ctx_valid ctx_acc "
                  "ctx_spad ctx_kept next_release tick_release "
                  "ev_time ev_tid ev_kind prio_key scen_n").split()
    _P_ARRAYS = ("now mode running accel_free_at run_started "
                 "last_mode_stamp tick_cs alive orig seed64 "
                 "rel_min tickR_min ev_min locked "
                 "act_cnt hi_cnt act_key hi_key res_lo_cnt "
                 "jobs done misses misses_by_mode mode_cycles lo_rel_hi "
                 "lo_done_hi cs_count exec_sum overhead").split()

    def _compact(self):
        """Drop finished points from the lockstep arrays."""
        keep = self.alive
        for name in self._PT_ARRAYS + self._P_ARRAYS:
            setattr(self, name, getattr(self, name)[keep])
        self.rngs = [r for r, k in zip(self.rngs, keep) if k]
        self.rands = [r.random for r in self.rngs]
        self.P = int(keep.sum())
        self._ar = np.arange(self.P)

    # -- pending interrupt table ----------------------------------------
    def _push_events(self, ip: np.ndarray, tids: np.ndarray,
                     kind: int, times: np.ndarray):
        """Insert one pending finish/overrun event per point in ``ip``
        (the event engine's heappush), widening the table when full."""
        while True:
            isfree = np.isinf(self.ev_time[ip])
            if isfree.any(axis=1).all():
                break
            k = self.K
            self.ev_time = np.hstack(
                [self.ev_time, np.full((self.P, k), np.inf)])
            self.ev_tid = np.hstack(
                [self.ev_tid, np.full((self.P, k), -1, np.int32)])
            self.ev_kind = np.hstack(
                [self.ev_kind, np.zeros((self.P, k), np.int8)])
            self.K = 2 * k
            isfree = np.isinf(self.ev_time[ip])
        col = np.argmax(isfree, axis=1)
        self.ev_time[ip, col] = times
        self.ev_tid[ip, col] = tids
        self.ev_kind[ip, col] = kind
        self.ev_min[ip] = np.minimum(self.ev_min[ip], times)

    # -- helpers --------------------------------------------------------
    def _next_tick(self, t: np.ndarray) -> np.ndarray:
        return (np.floor_divide(t, self.t_sr) + 1) * self.t_sr

    def _set_mode(self, idx: np.ndarray, new_mode: np.ndarray):
        """Masked _set_mode: stamp residency of the outgoing mode."""
        old = self.mode[idx]
        chg = new_mode != old
        if not chg.any():
            return
        ic, oc, nc = idx[chg], old[chg], new_mode[chg]
        self.mode_cycles[ic, oc] += self.now[ic] - self.last_mode_stamp[ic]
        self.last_mode_stamp[ic] = self.now[ic]
        self.mode[ic] = nc

    # -- advance_running + note_execution -------------------------------
    def _advance(self, idx: np.ndarray):
        run = self.running[idx]
        sel = (run >= 0).nonzero()[0]
        if not len(sel):
            return
        ip, it = idx[sel], run[sel]
        elapsed = self.now[ip] - self.run_started[ip]
        pos = (elapsed > 0).nonzero()[0]
        if not len(pos):
            return
        ip, it, elapsed = ip[pos], it[pos], elapsed[pos]
        self.exec_cy[ip, it] += elapsed
        self.exec_sum[ip] += elapsed
        self.run_started[ip] = self.now[ip]
        # GemminiRT.note_execution (exact integer growth model).  Fast
        # paths: growth is a no-op once the task holds its eta banks or
        # the scratchpad has no free bank left, and once the accumulator
        # is full — the steady state for nearly every advance.
        etab = self.etab[ip, it] * _BB
        if self.use_banks:
            have = self.r_bytes[ip, it]
            free = _NBANKS - self.locked[ip]
            growing = ((have < etab) & (free > 0)).nonzero()[0]
            if len(growing):
                gp, gt = ip[growing], it[growing]
                grow = np.floor(elapsed[growing]
                                * DMA_BYTES_PER_CYCLE).astype(np.int64)
                hg = have[growing]
                avail = hg + free[growing] * _BB
                want = np.minimum(np.minimum(etab[growing], avail),
                                  hg + grow)
                new = np.maximum(hg, want)
                self.r_bytes[gp, gt] = new
                self.locked[gp] += (new + _BB - 1) // _BB \
                    - (hg + _BB - 1) // _BB
                went = ((hg == 0) & (new > 0)
                        & ~self.is_hi[gp, gt]).nonzero()[0]
                if len(went):
                    self.res_lo_cnt[gp[went]] += 1
        else:
            have = self.spad[ip, it]
            growing = have < etab
            if growing.any():
                gp, gt = ip[growing], it[growing]
                grow = np.floor(elapsed[growing]
                                * DMA_BYTES_PER_CYCLE).astype(np.int64)
                hg = have[growing]
                others = self.spad[gp].sum(axis=1) - hg
                want = np.minimum(
                    np.minimum(etab[growing], np.maximum(_CAP - others, 0)),
                    hg + grow)
                self.spad[gp, gt] = np.maximum(hg, want)
        acc = self.acc_bytes[ip, it]
        filling = (acc < ACCUM_BYTES).nonzero()[0]
        if len(filling):
            fp, ft = ip[filling], it[filling]
            grow_acc = np.floor_divide(
                elapsed[filling] * DMA_BYTES_PER_CYCLE, 4).astype(np.int64)
            self.acc_bytes[fp, ft] = np.minimum(
                ACCUM_BYTES, acc[filling] + grow_acc)

    # -- mode progression (SS IV) ---------------------------------------
    def _mode_tick(self, idx: np.ndarray, m: np.ndarray):
        nl = (m != _LO).nonzero()[0]
        if not len(nl):
            return
        ip = idx[nl]
        cur = self.mode[ip]
        new = cur.copy()
        to_hi = (cur == _TRANS) & (self.res_lo_cnt[ip] <= 1)
        new[to_hi] = _HI
        to_lo = ~to_hi & (self.act_cnt[ip] == 0)
        new[to_lo] = _LO
        self._set_mode(ip, new)

    # -- blocking bookkeeping -------------------------------------------
    def _mark_blocked(self, ip: np.ndarray, it: np.ndarray):
        fresh = (np.isnan(self.blocked_since[ip, it])).nonzero()[0]
        if not len(fresh):
            return
        ip, it = ip[fresh], it[fresh]
        self.blocked_since[ip, it] = self.now[ip]
        run = self.running[ip]
        has_run = run >= 0
        run_lo = np.zeros(len(ip), bool)
        run_lo[has_run] = ~self.is_hi[ip[has_run], run[has_run]]
        ci_shape = self.is_hi[ip, it] & has_run & run_lo
        cause = np.where(ci_shape,
                         np.where(self.mode[ip] != _LO, _C_CI, _C_CIQ),
                         _C_PI).astype(np.int8)
        self.cause[ip, it] = cause

    def _record_unblock(self, ip: np.ndarray, it: np.ndarray,
                        at: np.ndarray):
        was = (~np.isnan(self.blocked_since[ip, it])).nonzero()[0]
        if not len(was):
            return
        ip, it, at = ip[was], it[was], at[was]
        dt = at - self.blocked_since[ip, it]
        cause = self.cause[ip, it]
        cause = np.where((cause == _C_CIQ) & (self.mode[ip] != _LO),
                         _C_CI, cause)
        pos = dt > 0
        ci = (pos & (cause == _C_CI)).nonzero()[0]
        pi = (pos & (cause != _C_CI)).nonzero()[0]
        if len(ci):
            self.log_ci.append((self.orig[ip[ci]], dt[ci]))
        if len(pi):
            self.log_pi.append((self.orig[ip[pi]], dt[pi]))
        self.blocked_since[ip, it] = np.nan
        self.cause[ip, it] = _C_NONE

    # -- context switch (Alg. 1) ----------------------------------------
    def _boundaries(self, ip: np.ndarray, it: np.ndarray) -> np.ndarray:
        """Preemption boundary per (point, running task), for the whole
        mixed-program batch in one vectorized pass."""
        pids = self.prog_id[ip, it].astype(np.int64)
        off = self.exec_cy[ip, it]
        total = self._prog_total[pids]
        base = np.zeros_like(off)
        wrap = off >= total
        if wrap.any():
            base[wrap] = np.floor_divide(off[wrap], total[wrap]) \
                * total[wrap]
            off = off - base
        pk = pids * float(_PID_KEY)
        if self.preempt == "instruction":
            off = np.minimum(np.maximum(off, 0.0), total - 1e-9)
            i = np.searchsorted(self._g_seg_key, pk + off, side="right")
            seg_start = (self._g_seg_key[i] - pk) - self._g_seg_cycles[i]
            within = off - seg_start
            pat = self._g_seg_pat[i]
            rep = np.floor_divide(within, pat)
            rem = within - rep * pat
            cum = self._g_pat_cumsum[i]
            k = (cum <= rem[:, None]).sum(axis=1)
            acc = cum[np.arange(len(off)), k]
            return np.trunc(base + seg_start + rep * pat + acc)
        i = np.searchsorted(self._g_op_key, pk + off, side="right")
        i = np.minimum(i, self._g_op_hi[pids])
        return np.trunc(base + self._g_op_end[i])

    def _dispatch(self, ip: np.ndarray, nxt: np.ndarray):
        n = len(ip)
        cur = self.running[ip]
        has_cur = (cur >= 0).nonzero()[0]
        switch = np.zeros(n)

        if len(has_cur):
            hp, hc = ip[has_cur], cur[has_cur]
            hn = nxt[has_cur]
            # drain to the preemption boundary
            boundary = self._boundaries(hp, hc)
            drain = np.maximum(
                0.0, np.minimum(boundary, self.demand[hp, hc])
                - self.exec_cy[hp, hc])
            self.exec_cy[hp, hc] += drain
            drain_i = np.trunc(drain).astype(np.int64)
            # context_save cost model (GemminiRT)
            acc = self.acc_bytes[hp, hc]
            acc_cy = _dma_vec(acc)
            if self.use_banks:
                resident = self.r_bytes[hp, hc]
                need = self.eta[hp, hn] + self.locked[hp] > _NBANKS
                spadsave = need & (resident > 0)
                remap_cy = _REMAP_CY
            else:
                resident = self.spad[hp, hc]
                spadsave = resident > 0
                remap_cy = 0
            spad_cy = np.where(spadsave, _dma_vec(resident), 0)
            br = drain_i + (_FF + _CFG_CY + remap_cy) + acc_cy + spad_cy
            # DRAM context + residency updates
            self.ctx_valid[hp, hc] = True
            self.ctx_acc[hp, hc] = acc
            self.ctx_spad[hp, hc] = np.where(spadsave, resident, 0)
            kept = ~spadsave
            self.ctx_kept[hp, hc] = kept
            sv_ = (spadsave).nonzero()[0]
            if len(sv_):
                if self.use_banks:
                    self.r_bytes[hp[sv_], hc[sv_]] = 0
                    self.locked[hp[sv_]] -= \
                        (resident[sv_] + _BB - 1) // _BB
                    lo_sel = (~self.is_hi[hp[sv_], hc[sv_]]).nonzero()[0]
                    if len(lo_sel):
                        self.res_lo_cnt[hp[sv_][lo_sel]] -= 1
                else:
                    self.spad[hp[sv_], hc[sv_]] = 0
            self.acc_bytes[hp, hc] = 0
            self.data_in_accel[hp, hc] = kept
            # HI-mode LO->LO preemption: full eviction of the old LO data
            lolo = ((self.mode[hp] == _HI)
                                  & ~self.is_hi[hp, hc]
                                  & ~self.is_hi[hp, hn]).nonzero()[0]
            if len(lolo):
                rb = self.r_bytes[hp[lolo], hc[lolo]]
                self.locked[hp[lolo]] -= (rb + _BB - 1) // _BB
                had = (rb > 0).nonzero()[0]
                if len(had):       # the preempted task is LO by definition
                    self.res_lo_cnt[hp[lolo][had]] -= 1
                self.r_bytes[hp[lolo], hc[lolo]] = 0
                self.data_in_accel[hp[lolo], hc[lolo]] = False
            self.status[hp, hc] = _INT
            self.cs_count[hp] += 1
            self.log_save.append((self.orig[hp], br))
            switch[has_cur] += br

        # context_restore for resumed tasks
        resume = ((self.pc[ip, nxt] > 0)
                                | (self.status[ip, nxt] == _INT)).nonzero()[0]
        if len(resume):
            rp, rt = ip[resume], nxt[resume]
            has_ctx = self.ctx_valid[rp, rt]
            acc_cy = np.where(has_ctx, _dma_vec(self.ctx_acc[rp, rt]), 0)
            reload = has_ctx & ~self.ctx_kept[rp, rt] \
                & (self.ctx_spad[rp, rt] > 0)
            spad_cy = np.where(reload, _dma_vec(self.ctx_spad[rp, rt]), 0)
            br = np.where(has_ctx, acc_cy + spad_cy + _RESTORE_FIXED, 0)
            rl = (reload).nonzero()[0]
            if len(rl):
                lp, lt = rp[rl], rt[rl]
                if self.use_banks:
                    br[rl] += _REMAP_CY
                    free = _NBANKS - self.locked[lp]
                    new = np.minimum(self.ctx_spad[lp, lt], free * _BB)
                    self.r_bytes[lp, lt] = new
                    self.locked[lp] += (new + _BB - 1) // _BB
                    came = ((new > 0)
                            & ~self.is_hi[lp, lt]).nonzero()[0]
                    if len(came):
                        self.res_lo_cnt[lp[came]] += 1
                else:
                    self.spad[lp, lt] = self.ctx_spad[lp, lt]
            hc2 = (has_ctx).nonzero()[0]
            if len(hc2):
                self.acc_bytes[rp[hc2], rt[hc2]] = \
                    self.ctx_acc[rp[hc2], rt[hc2]]
                self.data_in_accel[rp[hc2], rt[hc2]] = True
            self.log_restore.append((self.orig[rp], br))
            switch[resume] += br

        self.overhead[ip] += switch
        self.running[ip] = nxt
        self.status[ip, nxt] = _RUN
        self.pc[ip, nxt] = 1
        self._record_unblock(ip, nxt, self.now[ip] + switch)
        started = self.now[ip] + switch
        self.run_started[ip] = started
        self.accel_free_at[ip] = started
        rem = self.demand[ip, nxt] - self.exec_cy[ip, nxt]
        self._push_events(ip, nxt, 1, started + rem)
        arm = (self.is_hi[ip, nxt] & ~self.budget_overrun[ip, nxt]
               & (self.exec_cy[ip, nxt] < self.c_lo[ip, nxt]))
        if arm.any():
            ap, an = ip[arm], nxt[arm]
            self._push_events(
                ap, an, 2,
                started[arm] + (self.c_lo[ap, an] - self.exec_cy[ap, an]))

    # -- one scheduler invocation ---------------------------------------
    def _schedule(self, idx: np.ndarray):
        """One scheduler pass per point in ``idx``.  Callers have
        already advanced execution to ``now``; tick points were busy-
        filtered by the run loop, but a stale finish/overrun firing
        inside a context-switch window (its task was preempted with
        zero remaining drain) can still land here mid-switch — defer
        exactly like the event engine's tick re-push."""
        busy = (self.now[idx] < self.accel_free_at[idx]).nonzero()[0]
        if len(busy):
            b = idx[busy]
            self.tick_cs[b] = np.minimum(
                self.tick_cs[b], self._next_tick(self.accel_free_at[b]))
            idx = np.delete(idx, busy)
            if not len(idx):
                return
        m = self.mode[idx]
        self._mode_tick(idx, m)
        m = self.mode[idx]
        # pick_next via the maintained (priority, column) min-keys:
        #   LO-mode            -> min over active tasks
        #   off-LO, HI active  -> min over active HI tasks
        #   off-LO, no HI      -> AMC: none; HI-mode: min over active
        #                         (all LO); transition: resident-LO only
        key = self.act_key[idx]
        if m.any():
            hi_key = self.hi_key[idx]
            hi_active = self.hi_cnt[idx] > 0
            off_lo = m != _LO
            if self.drop_lo:                 # AMC: LO never runs off-LO
                key = np.where(off_lo, hi_key, key)
            else:
                key = np.where(off_lo & hi_active, hi_key, key)
                tr = (off_lo & ~hi_active & (m == _TRANS)).nonzero()[0]
                if len(tr):
                    # transition mode: a LO task may run only while its
                    # data is still resident (rare slow path)
                    rows = idx[tr]
                    ok = (self.status[rows] != _PEND) \
                        & (self.is_hi[rows] | self.data_in_accel[rows]
                           | (self.r_bytes[rows] > 0))
                    kk = np.where(ok, self.prio_key[rows], _EMPTY)
                    key[tr] = kk.min(axis=1)
        none = key >= _EMPTY
        nxt = (key % self.keypad).astype(np.int32)
        nxt[none] = -1
        # clear a stale running slot (event engine's defensive check)
        cur = self.running[idx]
        stale = (cur >= 0) & (self.status[idx, np.maximum(cur, 0)] != _RUN)
        if stale.any():
            self.running[idx[stale]] = -1
            cur = self.running[idx]
        act = ((nxt >= 0) & (cur != nxt)).nonzero()[0]
        if not len(act):
            return
        # a displaced current task blocks the newcomer until the switch
        blocked = act[cur[act] >= 0]
        if len(blocked):
            self._mark_blocked(idx[blocked], nxt[blocked])
        if self.preempt == "none":
            act = act[cur[act] < 0]        # cannot displace the running task
        if len(act):
            self._dispatch(idx[act], nxt[act])

    # -- event handlers --------------------------------------------------
    def _handle_release(self, idx: np.ndarray, tcol: np.ndarray):
        t = self.now[idx]
        self.next_release[idx, tcol] = t + self.period[idx, tcol]
        self.rel_min[idx] = self.next_release[idx].min(axis=1)
        if self.scen is not None:
            # absolute release-event counter (policy-independent CRN
            # key); draws below use the pre-bump value
            self.scen_n[idx, tcol] += 1
        st = self.status[idx, tcol]
        busy = (st != _PEND).nonzero()[0]
        if len(busy):
            # previous job still live: count one miss, skip this release
            bp, bt = idx[busy], tcol[busy]
            fresh = (self.job_deadline[bp, bt] != np.inf).nonzero()[0]
            if len(fresh):
                fp, ft = bp[fresh], bt[fresh]
                crit = self.is_hi[fp, ft].astype(np.int64)
                self.misses[fp, crit] += 1
                self.misses_by_mode[fp, self.mode[fp]] += 1
                self.job_deadline[fp, ft] = np.inf
        hi = self.is_hi[idx, tcol]
        free = st == _PEND
        if self.drop_lo:
            accept = (free & (hi | (self.mode[idx] == _LO))).nonzero()[0]
        else:
            accept = (free).nonzero()[0]
        if not len(accept):
            return
        ap, at_ = idx[accept], tcol[accept]
        ta = t[accept]
        self.status[ap, at_] = _READY
        # activate: bump counts, min-update the pick_next keys
        self.act_cnt[ap] += 1
        k = self.prio_key[ap, at_]
        self.act_key[ap] = np.minimum(self.act_key[ap], k)
        hi_sel = (self.is_hi[ap, at_]).nonzero()[0]
        if len(hi_sel):
            hp_ = ap[hi_sel]
            self.hi_cnt[hp_] += 1
            self.hi_key[hp_] = np.minimum(self.hi_key[hp_], k[hi_sel])
        self.pc[ap, at_] = 0
        self.exec_cy[ap, at_] = 0.0
        self.budget_overrun[ap, at_] = False
        self.job_release[ap, at_] = ta
        self.job_deadline[ap, at_] = ta + self.deadline_rel[ap, at_]
        # per-point rng draws, in the event engine's order.  Bound
        # ``Generator.random`` + the bit-exact identity
        # ``uniform(a, b) == a + (b - a) * random()`` (pinned by tests)
        # halve the per-draw cost of this Python loop.  The "nominal"
        # profile is the zero-jitter degenerate case (demand == C_LO,
        # no draws) shared with the jit backend's exactness gate.
        hi_a = hi[accept]
        c_a = self.c_lo[ap, at_]
        if self.demand_profile == "nominal":
            self.demand[ap, at_] = c_a
        else:
            op = self.overrun_prob
            w_hi = self.cf - 1.0
            w_lo = 1.0 - 0.7
            rands = self.rands
            demands = [0.0] * len(ap)
            for k, (p_, h, c) in enumerate(zip(ap.tolist(), hi_a.tolist(),
                                               c_a.tolist())):
                rnd = rands[p_]
                if h and rnd() < op:
                    demands[k] = c * (1.0 + w_hi * rnd())
                else:
                    demands[k] = c * (0.7 + w_lo * rnd())
            self.demand[ap, at_] = demands
        scen = self.scen
        if scen is not None and scen.affects_demand:
            n_pre = (self.scen_n[ap, at_] - 1).astype(np.uint64)
            m = demand_multiplier(scen, np, self.seed64[ap],
                                  at_.astype(np.uint64), n_pre, ta)
            self.demand[ap, at_] = self.demand[ap, at_] * m
        self.jobs[ap, hi_a.astype(np.int64)] += 1
        rel_hi_mask = ~hi_a & (self.mode[ap] != _LO)
        self.released_in_hi[ap, at_] = rel_hi_mask
        rel_hi = (rel_hi_mask).nonzero()[0]
        if len(rel_hi):
            self.lo_rel_hi[ap[rel_hi]] += 1
        tr = self._next_tick(ta)
        self.tick_release[ap, at_] = tr
        self.tickR_min[ap] = np.minimum(self.tickR_min[ap], tr)

    def _interrupt_guard(self, idx: np.ndarray, col: np.ndarray):
        """Pop one pending finish/overrun event per point; return the
        guard-passing subset (the event's task is the running task).
        Mirrors the event engine's ``running == tid and status ==
        RUNNING`` check; stale events fail it and are dropped."""
        tid = self.ev_tid[idx, col]
        kind = self.ev_kind[idx, col]
        self.ev_time[idx, col] = np.inf       # popped
        self.ev_min[idx] = self.ev_time[idx].min(axis=1)
        gsel = ((self.running[idx] == tid)
                & (self.status[idx, tid] == _RUN)).nonzero()[0]
        return idx[gsel], tid[gsel], kind[gsel]

    def _handle_interrupt(self, gi: np.ndarray, gt: np.ndarray,
                          kind: np.ndarray) -> np.ndarray:
        """Fire guard-passing finish/overrun events (points already
        advanced to the event time); returns points needing a scheduler
        pass.  A stale event whose task is running again reaches here
        too — its only effect is the advance the caller already did."""
        sched: List[np.ndarray] = []
        fin = (kind == 1).nonzero()[0]
        # finish: complete the job when the demand is met
        if len(fin):
            fp, ft = gi[fin], gt[fin]
            done = (self.exec_cy[fp, ft]
                    >= self.demand[fp, ft] - 1e-6).nonzero()[0]
            if len(done):
                dp, dt_ = fp[done], ft[done]
                self.status[dp, dt_] = _PEND
                crit = self.is_hi[dp, dt_].astype(np.int64)
                # deactivate: recompute the affected points' min-keys
                self.act_cnt[dp] -= 1
                hi_sel = (crit == 1).nonzero()[0]
                if len(hi_sel):
                    self.hi_cnt[dp[hi_sel]] -= 1
                pk = np.where(self.status[dp] != _PEND,
                              self.prio_key[dp], _EMPTY)
                self.act_key[dp] = pk.min(axis=1)
                self.hi_key[dp] = np.where(self.is_hi[dp], pk,
                                           _EMPTY).min(axis=1)
                self.done[dp, crit] += 1
                late = (self.now[dp] > self.job_deadline[dp, dt_]) \
                    .nonzero()[0]
                if len(late):
                    lp = dp[late]
                    self.misses[lp, crit[late]] += 1
                    self.misses_by_mode[lp, self.mode[lp]] += 1
                surv = (self.released_in_hi[dp, dt_]
                        & (self.now[dp]
                           <= self.job_deadline[dp, dt_])).nonzero()[0]
                if len(surv):
                    self.lo_done_hi[dp[surv]] += 1
                # GemminiRT.evict
                self.overhead[dp] += FLUSH_CYCLES
                rb = self.r_bytes[dp, dt_]
                self.locked[dp] -= (rb + _BB - 1) // _BB
                gone = ((rb > 0) & (crit == 0)).nonzero()[0]
                if len(gone):
                    self.res_lo_cnt[dp[gone]] -= 1
                self.r_bytes[dp, dt_] = 0
                self.spad[dp, dt_] = 0
                self.acc_bytes[dp, dt_] = 0
                self.ctx_valid[dp, dt_] = False
                self.data_in_accel[dp, dt_] = False
                self.demand[dp, dt_] = np.inf
                self.running[dp] = -1
                sched.append(dp)
        # overrun: flag the budget excess, degrade LO -> transition
        ovr = (kind == 2).nonzero()[0]
        if len(ovr):
            op_, ot = gi[ovr], gt[ovr]
            fire = ((self.exec_cy[op_, ot] >= self.c_lo[op_, ot] - 1e-6)
                    & ~self.budget_overrun[op_, ot]).nonzero()[0]
            if len(fire):
                fp, ft = op_[fire], ot[fire]
                self.budget_overrun[fp, ft] = True
                was_lo = (self.mode[fp] == _LO).nonzero()[0]
                if len(was_lo):
                    wp = fp[was_lo]
                    self._set_mode(wp, np.full(len(wp), _TRANS, np.int8))
                sched.append(fp)
        if not sched:
            return np.empty(0, np.int64)
        return np.concatenate(sched) if len(sched) > 1 else sched[0]

    # -- main loop --------------------------------------------------------
    def run(self) -> List[RunMetrics]:
        self._init_state()
        P0 = len(self.orig)
        T = self.T
        tail_state: Dict[int, tuple] = {}
        while True:
            P = self.P
            if P == 0:
                break
            cand = np.empty((P, 4))
            cand[:, 0] = self.rel_min
            cand[:, 1] = self.tickR_min
            cand[:, 2] = self.ev_min
            cand[:, 3] = self.tick_cs
            j = np.argmin(cand, axis=1)
            tmin = cand[self._ar, j]
            fire = self.alive & (tmin <= self.duration)
            expired = self.alive & ~fire
            if expired.any():
                # freeze tail state at expiry (the event engine's break)
                for p in (expired).nonzero()[0]:
                    tail_state[int(self.orig[p])] = self._tail_snapshot(p)
                self.alive[expired] = False
            if not fire.any():
                break
            self.now[fire] = tmin[fire]
            # release events (no scheduler pass of their own)
            ridx = (fire & (j == 0)).nonzero()[0]
            if len(ridx):
                tcol = np.argmin(self.next_release[ridx], axis=1)
                self._handle_release(ridx, tcol)
            # scheduler ticks: defer while a context switch is in flight
            tidx = (fire & (j == 1)).nonzero()[0]
            if len(tidx):
                tcol = np.argmin(self.tick_release[tidx], axis=1)
                self.tick_release[tidx, tcol] = np.inf
                self.tickR_min[tidx] = self.tick_release[tidx].min(axis=1)
            cidx = (fire & (j == 3)).nonzero()[0]
            if len(cidx):
                self.tick_cs[cidx] = np.inf
            ticks = np.concatenate([tidx, cidx]) \
                if len(cidx) else tidx
            # pending finish/overrun interrupts: pop + guard
            iidx = (fire & (j == 2)).nonzero()[0]
            if len(iidx):
                icol = np.argmin(self.ev_time[iidx], axis=1)
                gi, gt, gkind = self._interrupt_guard(iidx, icol)
            else:
                gi = gt = gkind = np.empty(0, np.int64)
            # one advance for every point that needs it this step
            # (interrupt targets + non-deferred tick points, disjoint)
            if len(ticks):
                busy = self.now[ticks] < self.accel_free_at[ticks]
                bsel = busy.nonzero()[0]
                if len(bsel):
                    b = ticks[bsel]
                    self.tick_cs[b] = np.minimum(
                        self.tick_cs[b],
                        self._next_tick(self.accel_free_at[b]))
                    ticks = ticks[(~busy).nonzero()[0]]
            adv = np.concatenate([gi, ticks]) if len(gi) else ticks
            if len(adv):
                self._advance(adv)
            if len(gi):
                extra = self._handle_interrupt(gi, gt, gkind)
                if len(extra):
                    ticks = np.concatenate([ticks, extra])
            if len(ticks):
                self._schedule(ticks)
            if self.P > 64 and self.alive.sum() < 0.5 * self.P:
                self._compact()
        # points that drained their event queues entirely (rare)
        for p in (self.alive).nonzero()[0]:
            tail_state[int(self.orig[p])] = self._tail_snapshot(p)
        return self._assemble(P0, tail_state)

    # -- tail accounting + RunMetrics assembly ---------------------------
    def _tail_snapshot(self, p: int) -> tuple:
        """Everything the tail accounting of run() needs, per point."""
        mode_cycles = self.mode_cycles[p].copy()
        mode_cycles[self.mode[p]] += self.duration - self.last_mode_stamp[p]
        live = (self.status[p] != _PEND) & self.valid[p] \
            & (self.duration > self.job_deadline[p])
        misses = self.misses[p].copy()
        for t in (live).nonzero()[0]:
            misses[int(self.is_hi[p, t])] += 1
        return (mode_cycles, misses, self.jobs[p].copy(),
                self.done[p].copy(), self.misses_by_mode[p].copy(),
                int(self.lo_rel_hi[p]), int(self.lo_done_hi[p]),
                int(self.cs_count[p]), float(self.exec_sum[p]),
                float(self.overhead[p]))

    def _assemble(self, P0: int, tail: Dict[int, tuple]) -> List[RunMetrics]:
        def per_point(log) -> List[List]:
            out: List[List] = [[] for _ in range(P0)]
            for ids, vals in log:
                for i, v in zip(ids.tolist(), vals.tolist()):
                    out[i].append(v)
            return out
        saves, restores = per_point(self.log_save), per_point(self.log_restore)
        pis, cis = per_point(self.log_pi), per_point(self.log_ci)
        out = []
        for p in range(P0):
            (mode_cycles, misses, jobs, done, mbm, lrh, ldh, csn,
             exs, ovh) = tail[p]
            out.append(RunMetrics(
                pi_blocking=pis[p], ci_blocking=cis[p],
                save_cycles=saves[p], restore_cycles=restores[p],
                jobs={"LO": int(jobs[0]), "HI": int(jobs[1])},
                done={"LO": int(done[0]), "HI": int(done[1])},
                misses={"LO": int(misses[0]), "HI": int(misses[1])},
                misses_by_mode={k: int(mbm[i])
                                for i, k in enumerate(_MODE_KEYS)},
                lo_released_in_hi=lrh, lo_done_in_hi=ldh,
                mode_cycles={k: float(mode_cycles[i])
                             for i, k in enumerate(_MODE_KEYS)},
                cs_count=csn, exec_cycles=exs, overhead_cycles=ovh))
        return out


def simulate_vbatch(tasksets: Sequence[List[TaskParams]],
                    programs: Dict[str, Program], policy: Policy, *,
                    seeds: Sequence[int], duration: float = 2e7,
                    overrun_prob: float = 0.3, cf: float = 2.0,
                    batch_size: int = 256,
                    select_backend: str = "numpy",
                    demand_profile: str = "sampled",
                    devices: Optional[int] = None,
                    scenario=None, device=None) -> List[RunMetrics]:
    """Vectorized batch counterpart of :func:`repro_torch.core.simulator
    .simulate_batch`: one independent simulated point per (taskset,
    seed) pair, the reference's ``simulate_vbatch`` signature.

    ``select_backend`` picks the lockstep executor:

      * ``"numpy"`` (default) — the host engine, bit-identical to the
        event engine per point (see the module docstring);
      * ``"jit"`` — the lockstep engine
        (``core.simulator_jit.simulate_jbatch``) on ``device``
        (``None``: the CUDA card, raising when there is none; ``"cpu"``
        only when asked for): statistically equivalent under demand
        jitter, exactly equivalent on ``demand_profile="nominal"``.
        ``"jax"`` is accepted as a deprecated alias.

    ``batch_size`` bounds the lockstep width so a straggler point cannot
    serialize an arbitrarily large batch.  ``devices`` and ``device``
    belong to the jit engine; the host backend rejects an explicit
    device count above 1 and any ``device``.
    """
    if select_backend not in BACKENDS:
        raise ValueError(
            f"unknown select_backend {select_backend!r}; "
            f"want one of {BACKENDS}")
    if demand_profile not in DEMAND_PROFILES:
        raise ValueError(
            f"unknown demand_profile {demand_profile!r}; "
            f"want one of {DEMAND_PROFILES}")
    scen = get_scenario(scenario)          # loud on unknown names
    if len(tasksets) != len(seeds):
        raise ValueError(f"{len(tasksets)} tasksets vs {len(seeds)} seeds")
    if select_backend in ("jit", "jax"):
        if select_backend == "jax":
            warnings.warn(
                "select_backend='jax' is a deprecated alias for 'jit' "
                "(different RNG realizations, aggregate metrics); pass "
                "'jit' explicitly or 'numpy' for bit-exact results",
                DeprecationWarning, stacklevel=2)
        from repro_torch.core import simulator_jit
        return simulator_jit.simulate_jbatch(
            tasksets, programs, policy, seeds=seeds, duration=duration,
            overrun_prob=overrun_prob, cf=cf, batch_size=batch_size,
            demand_profile=demand_profile, devices=devices, scenario=scen,
            device=device)
    if devices is not None and devices != 1:
        raise ValueError(
            f"devices={devices} requires select_backend='jit' — the "
            f"{select_backend!r} backend runs on the host and cannot "
            "shard over devices")
    if device is not None:
        raise ValueError(
            f"device={device!r} requires select_backend='jit' — the "
            f"{select_backend!r} backend runs on the host")
    out: List[RunMetrics] = []
    for lo in range(0, len(tasksets), batch_size):
        chunk_ts = list(tasksets[lo:lo + batch_size])
        chunk_seeds = list(seeds[lo:lo + batch_size])
        batch = _VecBatch(chunk_ts, programs, policy, seeds=chunk_seeds,
                          duration=duration, overrun_prob=overrun_prob,
                          cf=cf, demand_profile=demand_profile,
                          scenario=scen)
        out.extend(batch.run())
    return out
