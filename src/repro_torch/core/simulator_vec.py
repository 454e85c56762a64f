"""Batch preparation of the lockstep simulation (partial own copy of the
reference's ``core/simulator_vec.py``).

The reference's vectorized engine keeps every piece of per-point
simulator state in arrays indexed ``[point]`` or ``[point, task]`` and
advances hundreds of ``(taskset, seed)`` points per lockstep step.  The
port's lockstep engine (``core.simulator_jit``) starts from the same
batch: this module holds what it reads —

  * the constants of the state encoding and the GemminiRT cost model;
  * ``_VecProgram`` and ``_VecBatch``'s construction: the static
    per-task tables, the release phases drawn from each point's
    ``np.random.default_rng(seed)`` in the reference's order, and the
    globally keyed program-boundary tables;
  * ``simulate_vbatch``'s argument checks, routing ``"jit"`` (and its
    deprecated alias ``"jax"``) to the lockstep engine.

The NumPy stepping methods (``_VecBatch.run`` and its handlers), the
``"numpy"`` backend, arrive with the host-engine slice (ROADMAP queue 1
item 6.2); selecting it raises ``NotImplementedError``.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.isa import (BANK_BYTES, CONFIG_CYCLES,
                                  DMA_BYTES_PER_CYCLE, DMA_SETUP_CYCLES,
                                  FLUSH_CYCLES, FREEZE_CYCLES,
                                  REMAP_BLOCK_BYTES, SCRATCHPAD_BANKS)
from repro_torch.core.program import Program
from repro_torch.core.scheduler import Policy
from repro_torch.core.simulator import DEMAND_PROFILES, RunMetrics
from repro_torch.core.task import Crit, TaskParams
from repro_torch.scenarios import get_scenario, shifted_phases

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
    """Static tables and initial release phases of one batch of points
    that share (policy, duration, overrun_prob, cf)."""

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


def simulate_vbatch(tasksets: Sequence[List[TaskParams]],
                    programs: Dict[str, Program], policy: Policy, *,
                    seeds: Sequence[int], duration: float = 2e7,
                    overrun_prob: float = 0.3, cf: float = 2.0,
                    batch_size: int = 256,
                    select_backend: str = "numpy",
                    demand_profile: str = "sampled",
                    devices: Optional[int] = None,
                    scenario=None, device=None) -> List[RunMetrics]:
    """One independent simulated point per (taskset, seed) pair, the
    reference's ``simulate_vbatch`` signature.

    ``select_backend="jit"`` runs the lockstep engine
    (``core.simulator_jit.simulate_jbatch``) on ``device`` (``None``:
    the CUDA card, raising when there is none; ``"cpu"`` only when asked
    for); ``"jax"`` is its deprecated alias.  ``"numpy"``, the
    reference's default, is the host engine, which the port does not
    have yet: it raises ``NotImplementedError``.
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
    if select_backend == "numpy":
        raise NotImplementedError(
            "select_backend='numpy' (the host vec engine) is not ported "
            "yet: ROADMAP queue 1 item 6.2 brings it; use "
            "select_backend='jit'")
    if select_backend == "jax":
        warnings.warn(
            "select_backend='jax' is a deprecated alias for 'jit' "
            "(different RNG realizations, aggregate metrics); pass "
            "'jit' explicitly", DeprecationWarning, stacklevel=2)
    from repro_torch.core import simulator_jit
    return simulator_jit.simulate_jbatch(
        tasksets, programs, policy, seeds=seeds, duration=duration,
        overrun_prob=overrun_prob, cf=cf, batch_size=batch_size,
        demand_profile=demand_profile, devices=devices, scenario=scen,
        device=device)
