"""The lockstep simulation engine on the card (``select_backend="jit"``);
twin of the reference's ``core/simulator_jit.py``.

The reference compiles the whole MESC simulation step — candidate
min/argmin, every masked event handler (release, scheduler tick, pending
finish/overrun interrupt), the scheduler pass (mode progression,
pick_next, blocking bookkeeping) and the context-switch cost model —
into one ``jax.lax.while_loop``; the host only observes the final state.
The port runs the same step as PyTorch operations on the device:

  * ``_build_step``'s step is the reference's ``_step`` on torch
    tensors, with the same float operations in the same order (the
    integer counters are summed in one scatter-add, where order cannot
    matter).  It reads the grouped carry and writes every carried array
    once, at the end, in place (``copy_``), so the carry lives in static
    device tensors;
  * on CUDA, ``_Runner`` captures ONE CUDA graph of ``GRAPH_STEPS``
    consecutive steps per (points, tasks, table width, table sizes,
    static policy class) — the counterpart of the reference's
    ``_compiled_run`` memo — and the host replays it, reading one flag
    per replay: ``alive.any() & (steps < max_steps)``.  The step is a
    no-op for a point that is no longer alive (its events no longer
    fire), and a step past the loop's end is a no-op for every point
    (``go``), so replaying whole graphs changes nothing: the final carry,
    the step counter included, is the reference's;
  * on the CPU (``device="cpu"``, the tests) the same ``GRAPH_STEPS``-step
    loop runs eagerly with the same flag read.

There is no ``torch.compile``: a compiler may contract ``a*b + c`` into
a fused multiply-add and move results by an ulp.  Each torch operation
is one kernel and rounds once.  The reference's XLA:CPU build does
contract the demand draw's two ``c + a*u`` (see ``_fma``), and the port
reproduces that exactly.

RNG-equivalence contract (the reference's): demands are counter-based
draws, a splitmix64 hash of ``(seed, task, release_index)``, so results
do not depend on batch composition, table width or span.  On the
zero-jitter profile (``demand_profile="nominal"``) no in-loop draw
exists.  torch has no uint64 ``>>``, so the hash runs on int64 tensors
with masked shifts (``scenarios.crn.mix64_t``).

Grouped carry (the reference's layout, kept):

  * ``flags`` — ``(P, T)`` int32 bitfield: status, pc, cause,
    budget_overrun, data_in_accel, released_in_hi, ctx_valid, ctx_kept
    and the release counter;
  * six ``(P, T)`` float64 arrays (exec_cy, demand, job_deadline,
    blocked_since, next_release, tick_release);
  * four ``(P, T)`` int32 byte arrays (res_bytes, acc_bytes, ctx_acc,
    ctx_spad);
  * the pending-interrupt table ``ev_time`` ``(P, K)`` float64 and
    ``ev_pay`` ``(P, K)`` int32 (``tid * 4 + kind``);
  * the scenario state ``sn`` ``(P, T)`` int32, ``sw`` ``(P,)`` int32,
    ``sm`` ``(P,)`` float64;
  * ``pi`` ``(P, 24)`` int32 and ``pf`` ``(P, 14)`` float64 per-point
    blocks (state, then metric counters and accumulators).

Stale-interrupt pruning (``prune``): a pending finish/overrun entry
whose task ends the step with no live job and whose fire time precedes
that task's next release can never pass the firing guard again; it is
dropped (proof in the reference's module docstring).

The pending-interrupt table is fixed-width.  A push into a full table
sets a per-point overflow flag; those points are re-run at doubled
widths (``_run_chunk``), and a point still overflowing at the maximum
width raises an error naming it.  ``REPRO_JIT_TABLE_WIDTH`` /
``REPRO_JIT_TABLE_MAX`` override the ladder's bounds.

``devices`` splits each span's point axis into equal shards, the
counterpart of the reference's ``shard_map`` over logical host devices.
Each shard has its own runner, its own captured graph and its own CUDA
stream on the one card; the host issues one replay to every live shard
before it reads any flag (``_run_shards``), so the shards' graphs
overlap.  Points are independent, so the split changes no row.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import re
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.isa import (ACCUM_BYTES, DMA_BYTES_PER_CYCLE,
                                  DMA_SETUP_CYCLES, FLUSH_CYCLES)
from repro_torch.core.program import Program
from repro_torch.core.scheduler import Policy
from repro_torch.core.simulator import AggSamples, RunMetrics
from repro_torch.core.simulator_vec import (  # noqa: F401
    _BB, _C_CI, _C_CIQ, _C_NONE, _C_PI, _CAP, _CFG_CY, _FF, _HI, _INT,
    _LO, _MODE_KEYS, _NBANKS, _PEND, _PID_KEY, _READY, _REMAP_CY,
    _RESTORE_FIXED, _RUN, _TRANS, JIT_SIM_SEMANTICS_VERSION, _VecBatch)
from repro_torch.core.task import TaskParams
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.device_config import _env_int, resolve_device_count
from repro_torch.scenarios import (burst_multiplier_t,
                                   burst_window_index_t,
                                   demand_multiplier_t, get_scenario,
                                   mix64_t, u01_t)
from repro_torch.scenarios.crn import GOLD, as_int64

# pending-interrupt table: primary width, the give-up bound of the
# double-on-overflow retry ladder, and the padded sub-batch size retries
# are grouped into (bounds the number of captured graphs)
_K0 = 64
_K_MAX = 1024
_RETRY_BUCKET = 64

# switch for the stale-interrupt pruning pass; part of the runner key.
# Only tests flip it (pruned and unpruned runs must give equal rows).
_PRUNE_STALE = True

# span width on the CPU (the reference's cache-sized chunk); on CUDA a
# span is ``batch_size`` points, one graph replay advancing all of them
_STREAM_CHUNK = 64

# lockstep steps per CUDA-graph replay: the host reads one flag per
# replay; a replay past the loop's end costs its steps as no-ops
GRAPH_STEPS = 64

# "no eligible task" sentinel for the rank-compressed int32 pick_next
# keys (every real key is rank * (T+1) + column << 2**30)
_EMPTY32 = 2 ** 30

# ---- flags: the (P, T) int32 per-task bitfield -----------------------
# [1:0] status (PEND/READY/RUN/INT)   [2] pc>0     [4:3] blocking cause
# [5] budget_overrun   [6] data_in_accel   [7] released_in_hi
# [8] ctx_valid        [9] ctx_kept        [30:10] release counter
_FL_ST_M = 3
_FL_PC_SH = 2
_FL_CZ_SH = 3
_FL_BO_SH = 5
_FL_DIA_SH = 6
_FL_RH_SH = 7
_FL_CV_SH = 8
_FL_CK_SH = 9
_FL_RC_SH = 10          # 21 bits: < 2**21 accepted releases per task
_FL_CZ_M = 3 << _FL_CZ_SH

# ---- pi: the packed (P, 24) int32 per-point block --------------------
# [0] mode  [1] running tid  [2] locked banks  [3] resident-LO count
# [4] active count  [5] active-HI count  [6] alive  [7] table overflow
# [8:24] int metric counters (_MI_* offsets are relative to _I_MI):
#   [jobs_lo, jobs_hi, done_lo, done_hi, miss_lo, miss_hi, mbm_lo,
#    mbm_tr, mbm_hi, lo_rel_hi, lo_done_hi, cs_count, pi_n, ci_n,
#    save_n, restore_n]
(_I_MODE, _I_RUN, _I_LOCKED, _I_RESLO, _I_ACT, _I_HI,
 _I_ALIVE, _I_OVF) = range(8)
_I_MI = 8
_MI_JOBS, _MI_DONE, _MI_MISS, _MI_MBM = 0, 2, 4, 6
_MI_LO_REL, _MI_LO_DONE, _MI_CS = 9, 10, 11
_MI_PI_N, _MI_CI_N, _MI_SAVE_N, _MI_RESTORE_N = 12, 13, 14, 15
_MI_W = 16
_PI_W = _I_MI + _MI_W

# ---- pf: the packed (P, 14) float64 per-point block ------------------
# [0] now  [1] accel_free_at  [2] run_started  [3] last_mode_stamp
# [4] tick_cs  [5:14] float metric accumulators (_MF_* offsets are
# relative to _F_MF): [exec_sum, overhead, pi_sum, ci_sum, save_sum,
# restore_sum, mode_cycles_lo/tr/hi]
_F_NOW, _F_FREE, _F_RSTART, _F_LMS, _F_TICKCS = range(5)
_F_MF = 5
_MF_EXEC, _MF_OVERHEAD, _MF_PI, _MF_CI = 0, 1, 2, 3
_MF_SAVE, _MF_RESTORE, _MF_MC = 4, 5, 6
_MF_W = 9
_PF_W = _F_MF + _MF_W

_GOLD_I = as_int64(GOLD)
_F64, _I32, _I64 = torch.float64, torch.int32, torch.int64

#: what the last runs did: lockstep steps, graph replays (CPU: rounds of
#: GRAPH_STEPS eager steps), host syncs (a flag read per replay and the
#: final carry's read per run), graph captures, retried points and
#: spans.  ``reset_counts`` zeroes them.
COUNTS: Dict[str, int] = {"steps": 0, "replays": 0, "syncs": 0,
                          "captures": 0, "retried_points": 0, "spans": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _table_width() -> int:
    return _env_int("REPRO_JIT_TABLE_WIDTH", _K0)


def _table_max(k0: int) -> int:
    return max(_env_int("REPRO_JIT_TABLE_MAX", _K_MAX), k0)


# ----------------------------------------------------------------------
# Exact fused multiply-add
# ----------------------------------------------------------------------

def _split(a):
    """Veltkamp split: a == hi + lo, each with at most 26 significant
    bits, so products of halves are exact."""
    t = a * 134217729.0
    hi = t - (t - a)
    return hi, a - hi


def _fma(a, b, c):
    """``a * b + c`` rounded once, from float64 operations that each
    round once (Boldo and Melquiond's emulated FMA: Dekker's exact
    product, Knuth's exact sum, the low parts added with rounding to
    odd).  The reference's XLA:CPU build contracts the demand draw's
    ``c + a*u`` into an FMA, so the port computes exactly that; torch
    exposes no FMA and fuses nothing across operations."""
    uh = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    ul = ((ah * bh - uh) + ah * bl + al * bh) + al * bl
    th = c + uh
    bb = th - c
    tl = (c - (th - bb)) + (uh - bb)
    v = tl + ul
    bb = v - tl
    w = (tl - (v - bb)) + (ul - bb)
    # round v to odd: toward zero, then the last mantissa bit set
    vb = v.view(_I64)
    rz = torch.where(torch.signbit(w) == torch.signbit(v), vb, vb - 1)
    ro = torch.where(w == 0, vb, rz | 1)
    return th + ro.view(_F64)


# ----------------------------------------------------------------------
# The step (built once per static policy/profile class)
# ----------------------------------------------------------------------

def _get(arr, col):
    """arr[p, col[p]] (clamped columns; callers mask the result)."""
    return torch.gather(arr, 1, col.to(_I64)[:, None])[:, 0]


def _take(table, idx):
    """table[idx] along the first axis, the index clamped into range as
    a JAX gather clamps it."""
    return torch.index_select(table, 0,
                              idx.to(_I64).clamp(0, table.shape[0] - 1))


def _chain(arr, *writes):
    """One masked-write pass: ``writes`` are (where, val) pairs, ``where``
    a (P, W) mask (a column one-hot and a per-point mask), ``val`` a
    Python number or a (P,) tensor, applied lowest-precedence-first
    (later entries win on overlap, matching the sequential write order
    they replace), each in ``arr``'s dtype."""
    out = arr
    for where, val in writes:
        if isinstance(val, torch.Tensor):
            val = val.to(arr.dtype)[:, None]
        out = torch.where(where, val, out)
    return out


def _count(block, incs, k):
    """Add the int metric increments ``incs`` — (column, offset, mask):
    one count at ``column + offset`` (offset a per-point int32 tensor,
    or None) where ``mask`` holds — to the int32 counter ``block`` with
    one scatter-add (integer sums are exact in any order).  The column
    row is a constant kept in ``k``, made on the first (eager) step."""
    cols = tuple(col for col, _, _ in incs)
    base = k.get(cols)
    if base is None:
        base = k[cols] = torch.tensor(cols, dtype=_I64, device=block.device)
    zero = torch.zeros_like(incs[0][2], dtype=_I32)
    offs = torch.stack([zero if off is None else off for _, off, _ in incs],
                       dim=1)
    ones = torch.stack([m for _, _, m in incs], dim=1).to(_I32)
    inc = torch.zeros_like(block).scatter_add_(1, offs.to(_I64) + base, ones)
    return block + inc


def _dma(nbytes):
    """executor._dma_cycles on int64 tensors."""
    cy = DMA_SETUP_CYCLES + (nbytes + DMA_BYTES_PER_CYCLE - 1) \
        // DMA_BYTES_PER_CYCLE
    return torch.where(nbytes <= 0, 0, cy)


def _banks(nbytes):
    return (nbytes + _BB - 1) // _BB


def _bit(fl, sh):
    return (fl & (1 << sh)) != 0


def _boundaries(tb, pids, off, preempt: str):
    """Vectorized Program.next_{instruction,operator}_boundary over the
    globally keyed tables (the reference's float/int op order; a sorted
    search in place of its compare-and-count, same indices)."""
    total = _take(tb["prog_total"], pids)
    wrap = off >= total
    base = torch.where(wrap, torch.floor_divide(off, total) * total, 0.0)
    off = off - base
    pk = pids.to(_F64) * float(_PID_KEY)
    if preempt == "instruction":
        off = torch.minimum(torch.clamp_min(off, 0.0), total - 1e-9)
        q = pk + off
        i = torch.searchsorted(tb["seg_key"], q, right=True)
        seg_start = (_take(tb["seg_key"], i) - pk) \
            - _take(tb["seg_cycles"], i)
        within = off - seg_start
        pat = _take(tb["seg_pat"], i)
        rep = torch.floor_divide(within, pat)
        rem = within - rep * pat
        cum = _take(tb["pat_cumsum"], i)
        # rem < pat, the pattern's last cumsum, so kk is in range (the
        # clamp only keeps a gather on the card inside the table)
        kk = (cum <= rem[:, None]).sum(dim=1).clamp_max(cum.shape[1] - 1)
        acc = _get(cum, kk)
        return torch.trunc(base + seg_start + rep * pat + acc)
    q = pk + off
    i = torch.searchsorted(tb["op_key"], q, right=True)
    i = torch.minimum(i, _take(tb["op_hi"], pids))
    return torch.trunc(base + _take(tb["op_end"], i))


def _sample_demand(tb, sc, rcol, n, hi_r, c_lo_r):
    """Counter-based per-release demand draw: splitmix64 of
    (seed, task, release index)."""
    ctr = (rcol.to(_I64) << 33) + (n.to(_I64) << 1)
    s = tb["seed64"] + ctr * _GOLD_I
    u0 = u01_t(mix64_t(s))
    u1 = u01_t(mix64_t(s + _GOLD_I))
    over = hi_r & (u0 < sc["overrun_prob"])
    mag = torch.where(over, _fma(sc["cf"] - 1.0, u1, 1.0),
                      _fma(0.3, u1, 0.7))
    return c_lo_r * mag


def _build_step(use_banks: bool, drop_lo: bool, preempt: str,
                nominal: bool, prune: bool, scenario=None):
    """The lockstep step for one static config: ``step(tb, sc, c, k)``
    advances the carry ``c`` (a dict of tensors) by one event per live
    point, in place.  ``tb`` holds the batch's tables, ``sc`` its 0-dim
    scalars, ``k`` the task and table column ranges (built before any
    capture) and constants that the first, eager step adds."""

    def step(tb, sc, c, k):
        """One lockstep iteration: pop each live point's next event and
        apply the handlers as masked updates; every carried array is
        written once, at the end."""
        arT, arK = k["arT"], k["arK"]
        t_sr = sc["t_sr"]

        def next_tick(t):
            return (torch.floor_divide(t, t_sr) + 1) * t_sr

        def oh(col, ar):
            return col[:, None] == ar[None, :]

        mi_inc = []
        new = {}

        # ---- unpack the grouped carry -------------------------------
        flags = c["flags"]
        status_a = flags & _FL_ST_M
        pi, pf = c["pi"], c["pf"]
        mode0 = pi[:, _I_MODE]
        run0 = pi[:, _I_RUN]
        locked0 = pi[:, _I_LOCKED]
        res_lo0 = pi[:, _I_RESLO]
        act0 = pi[:, _I_ACT]
        hic0 = pi[:, _I_HI]
        alive0 = pi[:, _I_ALIVE] != 0
        ovf0 = pi[:, _I_OVF] != 0
        now0 = pf[:, _F_NOW]
        free0 = pf[:, _F_FREE]
        rs0 = pf[:, _F_RSTART]
        lms0 = pf[:, _F_LMS]
        tcs0 = pf[:, _F_TICKCS]
        # the while_loop's condition: a step taken after it fails
        # changes nothing (fire is false everywhere, alive is kept)
        go = alive0.any() & (c["steps"] < sc["max_steps"])

        # ---- candidate argmin over the four event sources -----------
        rel_min = c["next_release"].amin(dim=1)
        tickR_min = c["tick_release"].amin(dim=1)
        ev_min = c["ev_time"].amin(dim=1)
        cand = torch.stack([rel_min, tickR_min, ev_min, tcs0], dim=1)
        j = cand.argmin(dim=1)
        tmin = cand.amin(dim=1)
        fire = alive0 & (tmin <= sc["duration"]) & go
        now = torch.where(fire, tmin, now0)
        is_rel = fire & (j == 0)
        is_tickR = fire & (j == 1)
        is_cs = fire & (j == 3)
        is_int = fire & (j == 2)

        # ---- release events (no scheduler pass of their own) --------
        rcol = c["next_release"].argmin(dim=1)
        ohR = oh(rcol, arT)
        fl_r = _get(flags, rcol)
        st_r = fl_r & _FL_ST_M
        hi_r = _get(tb["is_hi"], rcol)
        crit_r = hi_r.to(_I32)
        # previous job still live: count one miss, skip this release
        fresh_miss = is_rel & (st_r != _PEND) \
            & (_get(c["job_deadline"], rcol) != float("inf"))
        mi_inc.append((_MI_MISS, crit_r, fresh_miss))
        mi_inc.append((_MI_MBM, mode0, fresh_miss))
        accept = is_rel & (st_r == _PEND)
        if drop_lo:                   # AMC: LO not released off-LO
            accept = accept & (hi_r | (mode0 == _LO))
        act1 = act0 + accept
        hic1 = hic0 + (accept & hi_r)
        c_lo_r = _get(tb["c_lo"], rcol)
        n_r = fl_r >> _FL_RC_SH
        if nominal:                   # zero-jitter profile: no draws
            dem = c_lo_r
        else:
            dem = _sample_demand(tb, sc, rcol, n_r, hi_r, c_lo_r)
        if scenario is not None:
            # scenario CRN draws keyed on the absolute release-event
            # counter ``sn`` (bumped for every release, accepted or not)
            sn_r = _get(c["sn"], rcol)
            if scenario.has_burst:
                wi = burst_window_index_t(scenario, now)
                fresh_bm = burst_multiplier_t(scenario, tb["seed64"], wi)
                # per-window draw cached in the carry: pure in
                # (seed, window), so reuse is exact
                bm = torch.where(wi == c["sw"], c["sm"], fresh_bm)
                new["sw"] = torch.where(is_rel, wi, c["sw"])
                new["sm"] = torch.where(is_rel, bm, c["sm"])
            else:
                bm = None
            # abs pins the (non-negative) product as in the reference
            dem = torch.abs(dem * demand_multiplier_t(
                scenario, tb["seed64"], rcol, sn_r, now, burst_m=bm))
            new["sn"] = _chain(c["sn"], (ohR & is_rel[:, None], sn_r + 1))
        mi_inc.append((_MI_JOBS, crit_r, accept))
        rel_hi = accept & ~hi_r & (mode0 != _LO)
        mi_inc.append((_MI_LO_REL, None, rel_hi))

        # ---- scheduler-tick pops (defer while a CS is in flight) ----
        ohT = oh(c["tick_release"].argmin(dim=1), arT)
        tcs1 = torch.where(is_cs, float("inf"), tcs0)
        tick_mask = is_tickR | is_cs
        busy_t = tick_mask & (now < free0)
        tcs2 = torch.where(busy_t,
                           torch.minimum(tcs1, next_tick(free0)), tcs1)
        tick_sched = tick_mask & ~busy_t

        # ---- pending finish/overrun interrupts: pop + guard ---------
        icol = c["ev_time"].argmin(dim=1)
        ohI = oh(icol, arK)
        pay_i = _get(c["ev_pay"], icol)
        itid = pay_i >> 2
        ikind = pay_i & 3
        tidc = torch.clamp_min(itid, 0).to(_I64)
        ohTid = oh(tidc, arT)
        fl_tid = _get(flags, tidc)
        guard = is_int & (run0 == itid) \
            & ((fl_tid & _FL_ST_M) == _RUN)

        # ---- one advance for every point that needs it this step ----
        runc = torch.clamp_min(run0, 0).to(_I64)
        ohRun = oh(runc, arT)
        elapsed = now - rs0
        do_adv = (guard | tick_sched) & (run0 >= 0) & (elapsed > 0)
        exec_r0 = _get(c["exec_cy"], runc)
        exec_r1 = torch.where(do_adv, exec_r0 + elapsed, exec_r0)
        rs1 = torch.where(do_adv, now, rs0)
        # GemminiRT.note_execution (exact integer growth model)
        etab_r = _get(tb["etab"], runc).to(_I64) * _BB
        grow = torch.floor(elapsed * DMA_BYTES_PER_CYCLE).to(_I64)
        have = _get(c["res_bytes"], runc).to(_I64)
        if use_banks:
            free = (_NBANKS - locked0).to(_I64)
            growing = do_adv & (have < etab_r) & (free > 0)
            want = torch.minimum(
                torch.minimum(etab_r, have + free * _BB), have + grow)
            rb_grown = torch.maximum(have, want)
            rb_1 = torch.where(growing, rb_grown, have)
            locked1 = locked0 + torch.where(
                growing, _banks(rb_grown) - _banks(have),
                0).to(_I32)
            went = growing & (have == 0) & (rb_grown > 0) \
                & ~_get(tb["is_hi"], runc)
            res_lo1 = res_lo0 + went
        else:
            growing = do_adv & (have < etab_r)
            others = c["res_bytes"].sum(dim=1) - have
            want = torch.minimum(
                torch.minimum(etab_r, torch.clamp_min(_CAP - others, 0)),
                have + grow)
            rb_1 = torch.where(growing, torch.maximum(have, want), have)
            locked1, res_lo1 = locked0, res_lo0
        acc_r0 = _get(c["acc_bytes"], runc).to(_I64)
        filling = do_adv & (acc_r0 < ACCUM_BYTES)
        grow_acc = torch.floor_divide(
            elapsed * DMA_BYTES_PER_CYCLE, 4).to(_I64)
        acc_1 = torch.where(
            filling, torch.clamp_max(acc_r0 + grow_acc, ACCUM_BYTES),
            acc_r0)

        # ---- fire guard-passing finish/overrun events ---------------
        done_m = guard & (ikind == 1) \
            & (exec_r1 >= _get(c["demand"], tidc) - 1e-6)
        hi_i = _get(tb["is_hi"], tidc)
        crit_i = hi_i.to(_I32)
        ddl_i = _get(c["job_deadline"], tidc)
        mi_inc.append((_MI_DONE, crit_i, done_m))
        late = done_m & (now > ddl_i)
        mi_inc.append((_MI_MISS, crit_i, late))
        mi_inc.append((_MI_MBM, mode0, late))
        surv = done_m & _bit(fl_tid, _FL_RH_SH) & (now <= ddl_i)
        mi_inc.append((_MI_LO_DONE, None, surv))
        act2 = act1 - done_m.to(_I32)
        hic2 = hic1 - (done_m & hi_i).to(_I32)
        # GemminiRT.evict
        if use_banks:
            locked2 = locked1 - torch.where(
                done_m, _banks(rb_1), 0).to(_I32)
            res_lo2 = res_lo1 - (done_m & (rb_1 > 0) & ~hi_i).to(_I32)
        else:
            locked2, res_lo2 = locked1, res_lo1
        run1 = torch.where(done_m, -1, run0)
        # overrun: flag the budget excess, degrade LO -> transition
        fire_o = guard & (ikind == 2) \
            & (exec_r1 >= _get(tb["c_lo"], tidc) - 1e-6) \
            & ~_bit(fl_tid, _FL_BO_SH)
        was_lo = fire_o & (mode0 == _LO)
        lms1 = torch.where(was_lo, now, lms0)
        mode1 = torch.where(was_lo, _TRANS, mode0)

        # ---- scheduler pass -----------------------------------------
        sched = tick_sched | done_m | fire_o
        # a stale event can land mid-switch: defer like a tick re-push
        busy_s = sched & (now < free0)
        tcs3 = torch.where(busy_s,
                           torch.minimum(tcs2, next_tick(free0)), tcs2)
        sched = sched & ~busy_s
        # mode progression (SS IV) off the carried aggregates
        mt = sched & (mode1 != _LO)
        to_hi = mt & (mode1 == _TRANS) & (res_lo2 <= 1)
        to_lo = mt & ~to_hi & (act2 == 0)
        mode2 = torch.where(to_hi, _HI, torch.where(to_lo, _LO, mode1))
        chg = mode2 != mode1
        lms2 = torch.where(chg, now, lms1)
        # pick_next via masked min over the rank-compressed
        # (priority, column) keys; the finishing task left the active
        # set this step, which the deferred status write hasn't
        # recorded yet — mask its column out here
        done_col = ohTid & done_m[:, None]
        active = (status_a != _PEND) & tb["valid"] & ~done_col
        act_key = torch.where(active, tb["key32"], _EMPTY32).amin(dim=1)
        hi_key = torch.where(active & tb["is_hi"], tb["key32"],
                             _EMPTY32).amin(dim=1)
        hi_active = hic2 > 0
        off_lo = mode2 != _LO
        if drop_lo:                   # AMC: LO never runs off-LO
            key = torch.where(off_lo, hi_key, act_key)
        else:
            key = torch.where(off_lo & hi_active, hi_key, act_key)
            # transition mode: a LO task may run only while its data is
            # still resident (the reference branches around this pass
            # when no point needs it; here it always runs and is
            # selected per point, which gives the same keys)
            need_tr = sched & off_lo & ~hi_active & (mode2 == _TRANS)
            resid = _bit(flags, _FL_DIA_SH)
            if use_banks:
                resid = resid | (c["res_bytes"] > 0)
            resid = resid & ~done_col
            if use_banks:
                resid = resid | (ohRun
                                 & (growing & (rb_grown > 0))[:, None])
            ok = active & (tb["is_hi"] | resid)
            key_tr = torch.where(ok, tb["key32"], _EMPTY32).amin(dim=1)
            key = torch.where(need_tr, key_tr, key)
        nxt = (key % (tb["valid"].shape[1] + 1)).to(_I32)
        nxt = torch.where(key >= _EMPTY32, -1, nxt)
        # clear a stale running slot (event engine's defensive check)
        curc = torch.clamp_min(run1, 0).to(_I64)
        ohC = oh(curc, arT)
        fl_c = _get(flags, curc)
        stale = sched & (run1 >= 0) & ((fl_c & _FL_ST_M) != _RUN)
        run2 = torch.where(stale, -1, run1)
        cur = run2
        act_m = sched & (nxt >= 0) & (cur != nxt)
        # a displaced current task blocks the newcomer until the switch
        nxtc = torch.clamp_min(nxt, 0).to(_I64)
        ohN = oh(nxtc, arT)
        fl_n = _get(flags, nxtc)
        hi_n = _get(tb["is_hi"], nxtc)
        hi_c = _get(tb["is_hi"], curc)
        blocked = act_m & (cur >= 0)
        bsince_0 = _get(c["blocked_since"], nxtc)
        fresh_b = blocked & torch.isnan(bsince_0)
        bsince_1 = torch.where(fresh_b, now, bsince_0)
        run_lo = (cur >= 0) & ~hi_c
        ci_shape = hi_n & run_lo
        cause_v = torch.where(
            ci_shape, torch.where(mode2 != _LO, _C_CI, _C_CIQ).to(_I32),
            _C_PI)
        cz_1 = torch.where(fresh_b, cause_v, (fl_n >> _FL_CZ_SH) & 3)
        if preempt == "none":         # cannot displace the running task
            act_m = act_m & (cur < 0)

        # ---- dispatch (context switch, Alg. 1) ----------------------
        has_cur = act_m & (cur >= 0)
        # drain to the preemption boundary
        boundary = _boundaries(tb, _get(tb["prog_id"], curc), exec_r1,
                               preempt)
        drain = torch.clamp_min(
            torch.minimum(boundary, _get(c["demand"], curc)) - exec_r1,
            0.0)
        exec_r2 = torch.where(has_cur, exec_r1 + drain, exec_r1)
        drain_i = torch.trunc(drain).to(_I64)
        # context_save cost model (GemminiRT)
        acc_cy = _dma(acc_1)
        if use_banks:
            need = _get(tb["eta"], nxtc) + locked2 > _NBANKS
            spadsave = need & (rb_1 > 0)
            remap_cy = _REMAP_CY
            resident = rb_1
        else:
            resident = _get(c["res_bytes"], curc).to(_I64)
            resident = torch.where(curc == runc, rb_1, resident)
            spadsave = resident > 0
            remap_cy = 0
        spad_cy = torch.where(spadsave, _dma(resident),
                              0)
        br_save = drain_i + (_FF + _CFG_CY + remap_cy) + acc_cy + spad_cy
        kept = ~spadsave
        sv = has_cur & spadsave
        # HI-mode LO->LO preemption: full eviction of the old LO data
        lolo = has_cur & (mode2 == _HI) & ~hi_c & ~hi_n
        if use_banks:
            locked3 = locked2 - torch.where(
                sv, _banks(resident), 0).to(_I32)
            res_lo3 = res_lo2 - (sv & ~hi_c).to(_I32)
            # the lolo eviction sees the residency left after the save
            rb_2 = torch.where(sv, 0, rb_1)
            locked4 = locked3 - torch.where(
                lolo, _banks(rb_2), 0).to(_I32)
            res_lo4 = res_lo3 - (lolo & (rb_2 > 0)).to(_I32)
        else:
            locked4, res_lo4 = locked2, res_lo2
        mi_inc.append((_MI_CS, None, has_cur))
        mi_inc.append((_MI_SAVE_N, None, has_cur))
        # context_restore for resumed tasks
        resume = act_m & (_bit(fl_n, _FL_PC_SH)
                          | ((fl_n & _FL_ST_M) == _INT))
        has_ctx = _bit(fl_n, _FL_CV_SH)
        ctx_acc_n = _get(c["ctx_acc"], nxtc).to(_I64)
        ctx_spad_n = _get(c["ctx_spad"], nxtc).to(_I64)
        acc_cy_r = torch.where(has_ctx, _dma(ctx_acc_n), 0)
        reload = resume & has_ctx & ~_bit(fl_n, _FL_CK_SH) \
            & (ctx_spad_n > 0)
        spad_cy_r = torch.where(reload, _dma(ctx_spad_n), 0)
        br_rest = torch.where(has_ctx,
                              acc_cy_r + spad_cy_r + _RESTORE_FIXED, 0)
        if use_banks:
            br_rest = br_rest + torch.where(reload, _REMAP_CY, 0)
            free_b = (_NBANKS - locked4).to(_I64)
            new_res = torch.minimum(ctx_spad_n, free_b * _BB)
            locked5 = locked4 + torch.where(
                reload, _banks(new_res), 0).to(_I32)
            res_lo5 = res_lo4 + (reload & (new_res > 0) & ~hi_n)
        else:
            new_res = ctx_spad_n
            locked5, res_lo5 = locked4, res_lo4
        mi_inc.append((_MI_RESTORE_N, None, resume))
        # commit the switch
        switch = torch.where(has_cur, br_save, 0).to(_F64) \
            + torch.where(resume, br_rest, 0).to(_F64)
        run3 = torch.where(act_m, nxt, run2)
        # _record_unblock(nxt, at=now + switch)
        at = now + switch
        was_b = act_m & ~torch.isnan(bsince_1)
        dt = at - bsince_1
        cz = torch.where((cz_1 == _C_CIQ) & (mode2 != _LO), _C_CI, cz_1)
        posd = was_b & (dt > 0)
        ci_m = posd & (cz == _C_CI)
        pi_m = posd & (cz != _C_CI)
        mi_inc.append((_MI_CI_N, None, ci_m))
        mi_inc.append((_MI_PI_N, None, pi_m))
        rs2 = torch.where(act_m, at, rs1)
        free1 = torch.where(act_m, at, free0)
        # future events for the new running task
        exec_n = _get(c["exec_cy"], nxtc)
        rem = _get(c["demand"], nxtc) - exec_n
        c_lo_n = _get(tb["c_lo"], nxtc)
        arm = act_m & hi_n & ~_bit(fl_n, _FL_BO_SH) & (exec_n < c_lo_n)
        t_fin = at + rem
        t_ovr = at + (c_lo_n - exec_n)
        ddl_new = now + _get(tb["deadline_rel"], rcol)
        nrel_new = now + _get(tb["period"], rcol)
        tr_new = next_tick(now)

        # ---- flag-write values (one RMW per write site) --------------
        # release: fresh job — set READY, clear pc/budget_overrun, set
        # released_in_hi, bump the release counter; keep cause/ctx bits
        keep_r = _FL_CZ_M | (1 << _FL_DIA_SH) | (1 << _FL_CV_SH) \
            | (1 << _FL_CK_SH)
        fl_release = (fl_r & keep_r) | _READY \
            | (rel_hi.to(_I32) << _FL_RH_SH) \
            | ((n_r + 1) << _FL_RC_SH)
        # finish: back to PENDING, data gone, context invalid
        fl_done = fl_tid & ~(_FL_ST_M | (1 << _FL_DIA_SH)
                             | (1 << _FL_CV_SH))
        # overrun: set budget_overrun (kept for non-dispatching points;
        # folded into fl_cur below when the same column is displaced)
        fl_fireo = fl_tid | (1 << _FL_BO_SH)
        # displaced current task: INTERRUPTED + ctx snapshot bits, with
        # an overrun fired on this very column this step folded in
        fl_c2 = fl_c | (fire_o.to(_I32) << _FL_BO_SH)
        fl_cur = (fl_c2 & ~(_FL_ST_M | (1 << _FL_DIA_SH)
                            | (1 << _FL_CV_SH) | (1 << _FL_CK_SH))) \
            | _INT \
            | ((kept & ~lolo).to(_I32) << _FL_DIA_SH) \
            | (1 << _FL_CV_SH) \
            | (kept.to(_I32) << _FL_CK_SH)
        # dispatched task: RUNNING + pc, blocking cause resolved, data
        # present again when a context reload happened
        st_n = torch.where(act_m, _RUN, fl_n & _FL_ST_M)
        pc_n = torch.where(act_m, 1, (fl_n >> _FL_PC_SH) & 1)
        cz_n = torch.where(was_b, _C_NONE,
                           torch.where(fresh_b, cause_v,
                                       (fl_n >> _FL_CZ_SH) & 3))
        dia_n = torch.where(resume & has_ctx, 1,
                            (fl_n >> _FL_DIA_SH) & 1)
        keep_n = ~(_FL_ST_M | (1 << _FL_PC_SH) | _FL_CZ_M
                   | (1 << _FL_DIA_SH))
        fl_nxt = (fl_n & keep_n) | st_n | (pc_n << _FL_PC_SH) \
            | (cz_n << _FL_CZ_SH) | (dia_n << _FL_DIA_SH)

        # ---- deferred writes: one pass per array --------------------
        def at(oh_, mask):
            return oh_ & mask[:, None]

        rel_w, acc_w = at(ohR, is_rel), at(ohR, accept)
        cur_w = at(ohC, has_cur)
        flags_new = _chain(flags, (acc_w, fl_release),
                           (done_col, fl_done),
                           (at(ohTid, fire_o), fl_fireo),
                           (cur_w, fl_cur),
                           (at(ohN, act_m | fresh_b), fl_nxt))
        new["flags"] = flags_new
        new["exec_cy"] = _chain(c["exec_cy"], (acc_w, 0.0),
                                (at(ohRun, do_adv | has_cur), exec_r2))
        new["demand"] = _chain(c["demand"], (done_col, float("inf")),
                               (acc_w, dem))
        new["job_deadline"] = _chain(
            c["job_deadline"], (at(ohR, fresh_miss), float("inf")),
            (acc_w, ddl_new))
        nrel_a = _chain(c["next_release"], (rel_w, nrel_new))
        new["next_release"] = nrel_a
        new["tick_release"] = _chain(c["tick_release"],
                                     (at(ohT, is_tickR), float("inf")),
                                     (acc_w, tr_new))
        new["blocked_since"] = _chain(c["blocked_since"],
                                      (at(ohN, fresh_b), now),
                                      (at(ohN, was_b), float("nan")))
        evict = done_m | sv | lolo if use_banks else done_m | sv
        new["res_bytes"] = _chain(
            c["res_bytes"],
            (at(ohRun, growing | evict),
             torch.where(evict, 0, rb_1)),
            (at(ohN, reload), new_res))
        new["acc_bytes"] = _chain(
            c["acc_bytes"],
            (at(ohRun, filling | done_m | has_cur),
             torch.where(done_m | has_cur, 0, acc_1)),
            (at(ohN, resume & has_ctx), ctx_acc_n))
        new["ctx_acc"] = _chain(c["ctx_acc"], (cur_w, acc_1))
        new["ctx_spad"] = _chain(
            c["ctx_spad"],
            (cur_w, torch.where(spadsave, resident,
                                0)))

        # ---- pending-interrupt table: pop + prune + push ------------
        ev_time, ev_pay = c["ev_time"], c["ev_pay"]
        popped = ohI & is_int[:, None]
        if prune:
            tid_k = torch.clamp_min(ev_pay >> 2, 0).to(_I64)
            st_k = torch.gather(flags_new & _FL_ST_M, 1, tid_k)
            nrel_k = torch.gather(nrel_a, 1, tid_k)
            dead = torch.isfinite(ev_time) & (st_k == _PEND) \
                & (ev_time < nrel_k)
            clear = popped | dead
        else:
            clear = popped
        # this step's freed slots (pop + pruned) are immediately
        # reusable by the pushes, like the event engine's heap
        isfree = torch.isinf(ev_time) | clear
        n_free = isfree.sum(dim=1)
        isfree8 = isfree.to(torch.uint8)
        oh1 = oh(isfree8.argmax(dim=1), arK)
        oh2 = oh((isfree & ~oh1).to(torch.uint8).argmax(dim=1), arK)
        do1 = act_m & (n_free >= 1)
        do2 = arm & (n_free >= 2)
        ovf1 = ovf0 | (act_m & (n_free < 1)) | (arm & (n_free < 2))
        ev_t = torch.where(clear, float("inf"), ev_time)
        w1, w2 = at(oh1, do1), at(oh2, do2)
        new["ev_time"] = _chain(ev_t, (w1, t_fin), (w2, t_ovr))
        new["ev_pay"] = _chain(ev_pay, (w1, nxtc * 4 + 1),
                               (w2, nxtc * 4 + 2))

        # ---- packed per-point blocks --------------------------------
        alive1 = fire | (alive0 & ~go)
        state_i = torch.stack([mode2, run3, locked5, res_lo5, act2, hic2,
                               alive1.to(_I32), ovf1.to(_I32)], dim=1)
        new["pi"] = torch.cat([state_i, _count(pi[:, _I_MI:], mi_inc, k)],
                              dim=1)
        state_f = torch.stack([now, free1, rs2, lms2, tcs3], dim=1)
        # float accumulators, each column's terms added in the
        # reference's order (float sums do not associate)
        mf = pf[:, _F_MF:]

        def acc(col, *terms):
            out = mf[:, col]
            for mask, val in terms:
                out = out + (torch.where(mask, val, 0.0)
                             if isinstance(val, torch.Tensor)
                             else mask.to(_F64) * val)
            return out

        d_lo, d_chg = now - lms0, now - lms1
        cols_mf = [
            acc(_MF_EXEC, (do_adv, elapsed)),
            acc(_MF_OVERHEAD, (done_m, float(FLUSH_CYCLES)),
                (act_m, switch)),
            acc(_MF_PI, (pi_m, dt)),
            acc(_MF_CI, (ci_m, dt)),
            acc(_MF_SAVE, (has_cur, br_save.to(_F64))),
            acc(_MF_RESTORE, (resume, br_rest.to(_F64)))]
        cols_mf += [acc(_MF_MC + m, (was_lo & (mode0 == m), d_lo),
                        (chg & (mode1 == m), d_chg)) for m in range(3)]
        new["pf"] = torch.cat([state_f, torch.stack(cols_mf, dim=1)], dim=1)
        new["steps"] = c["steps"] + go.to(_I64)
        for name, val in new.items():
            c[name].copy_(val)

    return step


# ----------------------------------------------------------------------
# Host driver: state build, runner, overflow retry, assembly
# ----------------------------------------------------------------------

def _rank_keys(b: _VecBatch) -> np.ndarray:
    """Rank-compress the (priority, column) int64 keys into int32:
    pick_next only compares keys *within* a point, so a per-point dense
    rank of the priorities preserves the selection (ties still break on
    the lowest column)."""
    pr = np.minimum(b.prio, 2 ** 40)
    key = np.empty((b.P, b.T), np.int32)
    cols = np.arange(b.T, dtype=np.int32)
    for p in range(b.P):
        distinct = np.unique(pr[p])
        key[p] = np.searchsorted(distinct, pr[p]).astype(np.int32) \
            * (b.T + 1) + cols
    return key


def _tables(b: _VecBatch, seeds: Sequence[int]) -> Dict[str, np.ndarray]:
    return {
        "seed64": np.asarray(seeds, dtype=np.int64),
        "valid": b.valid,
        "key32": _rank_keys(b),
        "period": b.period,
        "deadline_rel": b.deadline_rel,
        "c_lo": b.c_lo,
        "is_hi": b.is_hi,
        "eta": b.eta.astype(np.int32),
        "etab": b.etab.astype(np.int32),
        "prog_id": b.prog_id.astype(np.int32),
        "prog_total": b._prog_total.astype(np.float64),
        "seg_key": b._g_seg_key,
        "seg_cycles": b._g_seg_cycles,
        "seg_pat": b._g_seg_pat,
        "pat_cumsum": b._g_pat_cumsum,
        "op_key": b._g_op_key,
        "op_end": b._g_op_end,
        "op_hi": b._g_op_hi,
    }


def _carry0(b: _VecBatch, K: int) -> Dict[str, np.ndarray]:
    """Initial carry: the batch's release phases as the grouped arrays
    of the module docstring, plus empty packed metric blocks and an
    interrupt table of width ``K``."""
    P, T = b.P, b.T
    pi0 = np.zeros((P, _PI_W), np.int32)
    pi0[:, _I_RUN] = -1
    pi0[:, _I_ALIVE] = 1
    pf0 = np.zeros((P, _PF_W))
    pf0[:, _F_TICKCS] = np.inf
    return {
        "flags": np.zeros((P, T), np.int32),
        "exec_cy": np.zeros((P, T)),
        "demand": np.full((P, T), np.inf),
        "job_deadline": np.zeros((P, T)),
        "blocked_since": np.full((P, T), np.nan),
        "next_release": b.next_release,
        "tick_release": np.full((P, T), np.inf),
        "res_bytes": np.zeros((P, T), np.int32),
        "acc_bytes": np.zeros((P, T), np.int32),
        "ctx_acc": np.zeros((P, T), np.int32),
        "ctx_spad": np.zeros((P, T), np.int32),
        "ev_time": np.full((P, K), np.inf),
        "ev_pay": np.full((P, K), -1, np.int32),
        # scenario state: absolute release-event counter + the cached
        # per-window burst draw (window index, multiplier)
        "sn": np.zeros((P, T), np.int32),
        "sw": np.full((P,), -1, np.int32),
        "sm": np.ones((P,)),
        "pi": pi0,
        "pf": pf0,
        "steps": np.zeros((), np.int64),
    }


def _max_steps(b: _VecBatch, duration: float) -> int:
    """Loose per-point event-count bound — a diverging loop is an engine
    bug and must surface as an error, not a hang."""
    with np.errstate(divide="ignore"):
        rel = np.where(b.valid, duration / b.period + 2, 0.0).sum(axis=1)
    return int(64 * (rel.max() + 16) + 65536)


class _Runner:
    """Static device tensors (tables, scalars, carry) and, on CUDA, the
    captured graph of ``steps`` lockstep steps and the stream it runs on,
    for one shard of one (shape, policy class) key.  ``start`` loads a
    shard, ``advance`` runs one graph replay (on the CPU: the same steps
    eagerly), ``more`` reads the flag and ``finish`` the final carry;
    :func:`_run_shards` drives the shards of a span together."""

    def __init__(self, step, tb: Dict[str, np.ndarray],
                 carry: Dict[str, np.ndarray], device: torch.device,
                 steps: int):
        self.step, self.device, self.steps = step, device, steps
        self.tb = {k: torch.from_numpy(np.array(v)).to(device)
                   for k, v in tb.items()}
        self.c = {k: torch.from_numpy(np.array(v)).to(device)
                  for k, v in carry.items()}
        self.sc = {k: torch.zeros((), dtype=_F64, device=device)
                   for k in ("t_sr", "overrun_prob", "cf", "duration")}
        self.sc["max_steps"] = torch.zeros((), dtype=_I64, device=device)
        T, K = carry["flags"].shape[1], carry["ev_time"].shape[1]
        self.k = {"arT": torch.arange(T, device=device),
                  "arK": torch.arange(K, device=device)}
        self.flag = torch.zeros((), dtype=torch.bool, device=device)
        self.graph = None
        # every copy, capture, replay and read of this shard is ordered
        # on its own stream, so shards overlap on the card and a load
        # never races another shard's replay
        self.stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None

    def _on_stream(self):
        return torch.cuda.stream(self.stream) if self.stream is not None \
            else contextlib.nullcontext()

    def _load(self, tb, sc, carry) -> None:
        for k, v in tb.items():
            self.tb[k].copy_(torch.from_numpy(np.array(v)))
        for k, v in sc.items():
            self.sc[k].fill_(v)
        for k, v in carry.items():
            self.c[k].copy_(torch.from_numpy(np.array(v)))

    def _body(self) -> None:
        for _ in range(self.steps):
            self.step(self.tb, self.sc, self.c, self.k)
        alive = (self.c["pi"][:, _I_ALIVE] != 0).any()
        self.flag.copy_(alive & (self.c["steps"] < self.sc["max_steps"]))

    def _capture(self, tb, sc, carry, body=None, debug: bool = False):
        """Warm up one step eagerly on a side stream, reload the batch,
        then capture ``body`` (default ``_body``); a failed capture
        raises.  Runs on the shard's stream; ``debug`` keeps the graph's
        nodes for ``debug_dump``."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.step(self.tb, self.sc, self.c, self.k)
        cur.wait_stream(side)
        self._load(tb, sc, carry)
        torch.cuda.synchronize(self.device)
        # a debug graph keeps its cudaGraph_t for debug_dump
        graph = torch.cuda.CUDAGraph(keep_graph=debug)
        if debug:
            graph.enable_debug_mode()
        with torch.cuda.graph(graph):
            (body or self._body)()
        COUNTS["captures"] += 1
        return graph

    def start(self, tb, sc, carry) -> None:
        """Load a shard (and capture the graph on first CUDA use; the
        capture leaves the shard loaded)."""
        with self._on_stream():
            self._load(tb, sc, carry)
            if self.stream is not None and self.graph is None:
                self.graph = self._capture(tb, sc, carry)

    def advance(self) -> None:
        with self._on_stream():
            if self.graph is not None:
                self.graph.replay()
            else:
                self._body()
        COUNTS["replays"] += 1

    def more(self) -> bool:
        """The flag of the last ``advance``: points alive and the step
        bound not reached."""
        with self._on_stream():
            go = bool(self.flag)
        COUNTS["syncs"] += 1
        return go

    def finish(self) -> Dict[str, np.ndarray]:
        with self._on_stream():
            out = {k: v.cpu().numpy().copy() for k, v in self.c.items()}
        COUNTS["syncs"] += 1                  # the final carry's read
        COUNTS["steps"] += int(out["steps"])
        return out


def _run_shards(runners: Sequence[_Runner], states) -> List[Dict]:
    """Run each shard's runner from its (tables, scalars, carry) until
    its flag says the loop is over.  Each round issues one replay to
    every live shard before reading any flag, so the shards' streams
    overlap on the card; a finished shard is not replayed again.  On the
    CPU the shards run one after another.  Returns the final carries."""
    for r, st in zip(runners, states):
        r.start(*st)
    live = list(runners)
    while live:
        for r in live:
            r.advance()
        live = [r for r in live if r.more()]
    return [r.finish() for r in runners]


# runner groups (one runner per shard) by key, oldest first; at most
# _MAX_RUNNERS groups are kept, so a campaign's d shards are never
# evicted one by one
_RUNNERS: Dict[Tuple, List[_Runner]] = {}
_MAX_RUNNERS = 16

# per-point tables (split with the points); the rest are the programs'
# global tables, which every shard holds whole
_TB_PER_POINT = frozenset({
    "seed64", "valid", "key32", "period", "deadline_rel", "c_lo",
    "is_hi", "eta", "etab", "prog_id"})


def _runners_for(policy: Policy, nominal: bool, scenario,
                 tb: Dict[str, np.ndarray], carry: Dict[str, np.ndarray],
                 device: torch.device, steps: int,
                 shards: int = 1) -> List[_Runner]:
    """The ``shards`` runners of this static class and (shard) shape
    set, built on first use (each graph is captured on its first CUDA
    run)."""
    shapes = tuple((k, v.shape) for k, v in sorted(tb.items())) \
        + tuple((k, v.shape) for k, v in sorted(carry.items()))
    key = (policy.use_banks, policy.drop_lo_in_hi, policy.preemption,
           nominal, _PRUNE_STALE, scenario, shapes, str(device), steps,
           shards)
    rs = _RUNNERS.get(key)
    if rs is None:
        step = _build_step(policy.use_banks, policy.drop_lo_in_hi,
                           policy.preemption, nominal, _PRUNE_STALE,
                           scenario)
        while len(_RUNNERS) >= _MAX_RUNNERS:
            _RUNNERS.pop(next(iter(_RUNNERS)))
        rs = _RUNNERS[key] = [_Runner(step, tb, carry, device, steps)
                              for _ in range(shards)]
    return rs


def _shard(tree: Dict[str, np.ndarray], lo: int, hi: int,
           per_point) -> Dict[str, np.ndarray]:
    return {k: (v[lo:hi] if k in per_point else v) for k, v in tree.items()}


def _prepare(b: _VecBatch, policy: Policy, seeds: Sequence[int],
             duration: float, overrun_prob: float, cf: float,
             nominal: bool, K: int, scenario=None,
             device: torch.device = torch.device("cpu"), shards: int = 1):
    """The runners of a prepared batch split into ``shards`` equal
    shards of its points, and the (tables, scalars, carry) each is
    loaded with."""
    if b.P % shards:
        raise ValueError(
            f"sharded run needs the point count ({b.P}) divisible by "
            f"the device count ({shards}); the span planner pads to a "
            "devices x chunk rectangle")
    tb = _tables(b, seeds)
    carry = _carry0(b, K)
    sc = {"t_sr": float(policy.t_sr), "overrun_prob": float(overrun_prob),
          "cf": float(cf), "duration": float(duration),
          "max_steps": _max_steps(b, duration)}
    c = b.P // shards
    per_carry = frozenset(carry) - {"steps"}
    states = [(_shard(tb, i * c, (i + 1) * c, _TB_PER_POINT), sc,
               _shard(carry, i * c, (i + 1) * c, per_carry))
              for i in range(shards)]
    runners = _runners_for(policy, nominal, scenario, states[0][0],
                           states[0][2], device, GRAPH_STEPS, shards)
    return runners, states


def _run_once(b: _VecBatch, policy: Policy, seeds: Sequence[int],
              duration: float, overrun_prob: float, cf: float,
              nominal: bool, K: int, scenario=None,
              device: torch.device = torch.device("cpu"), devices: int = 1
              ) -> Dict[str, np.ndarray]:
    """One run of a prepared batch at interrupt-table width ``K``, its
    points split over ``devices`` shards; returns the final carry as
    NumPy arrays (the shards' rows in order, ``steps`` their most)."""
    runners, states = _prepare(b, policy, seeds, duration, overrun_prob,
                               cf, nominal, K, scenario, device, devices)
    outs = _run_shards(runners, states)
    final = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]
             if k != "steps"}
    final["steps"] = np.max([o["steps"] for o in outs])
    final["overflow"] = final["pi"][:, _I_OVF] != 0
    max_steps = states[0][1]["max_steps"]
    if int(final["steps"]) >= max_steps and final["pi"][:, _I_ALIVE].any():
        raise RuntimeError(
            f"jit engine: lockstep loop hit the {max_steps}-step "
            "safety bound with live points remaining")
    return final


def _run_chunk(tasksets, programs, policy, seeds, duration, overrun_prob,
               cf, demand_profile: str,
               point_ids: Optional[Sequence[int]] = None, scenario=None,
               device: torch.device = torch.device("cpu"), devices: int = 1
               ) -> List[RunMetrics]:
    """Simulate one span with the per-point overflow-retry ladder.

    The span first runs at the primary interrupt-table width, split over
    ``devices`` shards.  Points whose table overflowed are re-run in
    padded single-shard sub-batches at doubled widths until they fit;
    the counter-based RNG makes every retry bit-deterministic, so a
    point's row does not depend on its batch, table width or shard.  A
    point that still overflows at the maximum width raises an error
    naming it: metrics computed from a saturated table would silently
    drop interrupts.
    """
    nominal = demand_profile == "nominal"
    scenario = get_scenario(scenario)
    # only demand-affecting components reach the loop (phase shift is
    # applied at batch init, instance loss is serving-only)
    loop_scen = scenario if scenario is not None \
        and scenario.affects_demand else None
    out: List[Optional[RunMetrics]] = [None] * len(tasksets)
    idx = list(range(len(tasksets)))
    K = _table_width()
    k_max = _table_max(K)
    first = True
    while idx:
        ts = [tasksets[i] for i in idx]
        sd = [int(seeds[i]) for i in idx]
        # pad retry sub-batches up to the bucket size so the ladder
        # reuses one runner per (bucket, K) instead of one per subset
        # shape (padded copies are simulated and discarded)
        if not first:
            COUNTS["retried_points"] += len(ts)
            if len(ts) < _RETRY_BUCKET:
                pad = _RETRY_BUCKET - len(ts)
                ts = ts + [ts[-1]] * pad
                sd = sd + [sd[-1]] * pad
        b = _VecBatch(ts, programs, policy, seeds=sd, duration=duration,
                      overrun_prob=overrun_prob, cf=cf,
                      scenario=scenario)
        final = _run_once(b, policy, sd, duration, overrun_prob, cf,
                          nominal, K, scenario=loop_scen, device=device,
                          devices=devices if first else 1)
        metrics = _assemble(b, final, duration)
        overflow = final["overflow"]
        redo = []
        for pos, i in enumerate(idx):
            if overflow[pos]:
                redo.append(i)
            else:
                out[i] = metrics[pos]
        idx = redo
        K *= 2
        first = False
        if idx and K > k_max:
            pts = ", ".join(
                f"(taskset {point_ids[i] if point_ids is not None else i}"
                f", seed {int(seeds[i])})" for i in idx)
            raise RuntimeError(
                f"jit engine: pending-interrupt table for {len(idx)} "
                f"point(s) still overflowed at the maximum width "
                f"{k_max} — refusing to return metrics from a "
                f"saturated table.  Affected (taskset index, seed): "
                f"[{pts}].  Raise REPRO_JIT_TABLE_MAX (or unset "
                f"REPRO_JIT_TABLE_WIDTH) to widen the retry ladder.")
    return out  # type: ignore[return-value]


def _assemble(b: _VecBatch, s: Dict[str, np.ndarray],
              duration: float) -> List[RunMetrics]:
    """Tail accounting (the event engine's post-loop pass) + RunMetrics
    assembly from the final grouped carry."""
    P = b.P
    out: List[RunMetrics] = []
    status = s["flags"] & _FL_ST_M
    live = (status != _PEND) & b.valid \
        & (duration > s["job_deadline"])
    mi = s["pi"][:, _I_MI:]
    mf = s["pf"][:, _F_MF:]
    mode = s["pi"][:, _I_MODE]
    lms = s["pf"][:, _F_LMS]
    for p in range(P):
        mode_cycles = mf[p, _MF_MC:_MF_MC + 3].copy()
        mode_cycles[mode[p]] += duration - lms[p]
        misses = mi[p, _MI_MISS:_MI_MISS + 2].astype(np.int64).copy()
        for t in live[p].nonzero()[0]:
            misses[int(b.is_hi[p, t])] += 1
        out.append(RunMetrics(
            pi_blocking=AggSamples(mf[p, _MF_PI], mi[p, _MI_PI_N]),
            ci_blocking=AggSamples(mf[p, _MF_CI], mi[p, _MI_CI_N]),
            save_cycles=AggSamples(mf[p, _MF_SAVE], mi[p, _MI_SAVE_N]),
            restore_cycles=AggSamples(mf[p, _MF_RESTORE],
                                      mi[p, _MI_RESTORE_N]),
            jobs={"LO": int(mi[p, _MI_JOBS]),
                  "HI": int(mi[p, _MI_JOBS + 1])},
            done={"LO": int(mi[p, _MI_DONE]),
                  "HI": int(mi[p, _MI_DONE + 1])},
            misses={"LO": int(misses[0]), "HI": int(misses[1])},
            misses_by_mode={k: int(mi[p, _MI_MBM + i])
                            for i, k in enumerate(_MODE_KEYS)},
            lo_released_in_hi=int(mi[p, _MI_LO_REL]),
            lo_done_in_hi=int(mi[p, _MI_LO_DONE]),
            mode_cycles={k: float(mode_cycles[i])
                         for i, k in enumerate(_MODE_KEYS)},
            cs_count=int(mi[p, _MI_CS]),
            exec_cycles=float(mf[p, _MF_EXEC]),
            overhead_cycles=float(mf[p, _MF_OVERHEAD])))
    return out


def _plan_spans(n: int, chunk: int,
                devices: int) -> List[Tuple[List[int], int, int]]:
    """Split ``n`` points into ``(indices, real, devices)`` spans.

    A span is one run: a ``d * c`` rectangle (``c`` points per shard)
    padded with copies of its last point so the shards are equal;
    padded copies are simulated and discarded.  The first (possibly
    only) span of a small batch shrinks ``d`` and ``c`` to the batch; a
    later ragged tail pads up to the full common shape so it reuses the
    first span's runners.  ``devices=1`` is the one-card plan.
    """
    spans: List[Tuple[List[int], int, int]] = []
    lo = 0
    while lo < n:
        real = min(chunk * devices, n - lo)
        if lo == 0:
            d = min(devices, real)
            c = min(chunk, -(-real // d))
        else:
            d, c = devices, chunk
        idxs = list(range(lo, lo + real))
        idxs += [idxs[-1]] * (d * c - real)
        spans.append((idxs, real, d))
        lo += real
    return spans


def simulate_jbatch(tasksets: Sequence[List[TaskParams]],
                    programs: Dict[str, Program], policy: Policy, *,
                    seeds: Sequence[int], duration: float = 2e7,
                    overrun_prob: float = 0.3, cf: float = 2.0,
                    batch_size: int = 512,
                    demand_profile: str = "sampled",
                    devices: Optional[int] = None,
                    scenario=None, device=None) -> List[RunMetrics]:
    """Lockstep batch simulation on ``device`` (``None``: the CUDA card,
    raising when there is none; the CPU only when ``"cpu"`` is passed),
    the point axis split over ``devices`` shards (``None``: the
    ``REPRO_DEVICES`` default; see ``runtime.device_config``).

    On CUDA a shard holds up to ``batch_size`` points and replays its own
    graph on its own stream; on the CPU shards are at most
    ``_STREAM_CHUNK`` points and run one after another.  Rows are per
    point and do not depend on the span, the shard count, the table width
    or the batch composition.
    """
    n = len(tasksets)
    if n != len(seeds):
        raise ValueError(f"{n} tasksets vs {len(seeds)} seeds")
    devices = resolve_device_count(devices)
    dev = resolve_device(device)
    chunk = max(1, batch_size if dev.type == "cuda"
                else min(batch_size, _STREAM_CHUNK))
    out: List[RunMetrics] = []
    for idxs, real, d in _plan_spans(n, chunk, devices):
        COUNTS["spans"] += 1
        part = _run_chunk([tasksets[i] for i in idxs], programs, policy,
                          [int(seeds[i]) for i in idxs], duration,
                          overrun_prob, cf, demand_profile,
                          point_ids=idxs, scenario=scenario, device=dev,
                          devices=d)
        out.extend(part[:real])
    return out


# kernel nodes of a CUDA graph's DOT dump (``CUDAGraph.debug_dump``):
# each node is a record whose label names its type on the first line
_DOT_NODE_RE = re.compile(r'^\s*"?\w+"?\s*\[[^\]]*label="\{?\s*(\w+)',
                          re.M)
_FREE_NODES = ("MEMCPY", "MEMSET", "EMPTY")


def while_body_kernels(text: str) -> int:
    """Kernel nodes in the DOT text of one captured lockstep step
    (``torch.cuda.CUDAGraph.debug_dump`` of a graph captured with
    ``enable_debug_mode``): the kernels the card launches per replay.
    Memcpy, memset and empty nodes are skipped, as the reference's count
    of XLA thunks in its while body skips tuple plumbing.  Divide by the
    graph's steps for the kernels of one step."""
    kinds = _DOT_NODE_RE.findall(text)
    return sum(1 for k in kinds if k.upper() not in _FREE_NODES)


def lockstep_kernel_count(tasksets: Sequence[List[TaskParams]],
                          programs: Dict[str, Program], policy: Policy,
                          *, seeds: Sequence[int], duration: float = 2e7,
                          overrun_prob: float = 0.3, cf: float = 2.0,
                          demand_profile: str = "sampled",
                          table_width: Optional[int] = None,
                          scenario=None, device=None) -> int:
    """Kernels of one lockstep step for this batch's shape and
    configuration: one step (without the replay's flag) captured in a
    CUDA graph with debug mode on, counted by :func:`while_body_kernels`
    in its DOT dump.  The
    counterpart of the reference's count of XLA kernels in its while
    body.  On the CPU it raises ``ValueError``: there is no graph to
    count."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"lockstep_kernel_count needs a CUDA device, got "
                         f"{dev}: there is no graph to count on the CPU")
    nominal = demand_profile == "nominal"
    scenario = get_scenario(scenario)
    loop_scen = scenario if scenario is not None \
        and scenario.affects_demand else None   # as simulate_jbatch
    K = _table_width() if table_width is None else table_width
    b = _VecBatch(tasksets, programs, policy,
                  seeds=[int(s) for s in seeds], duration=duration,
                  overrun_prob=overrun_prob, cf=cf, scenario=scenario)
    tb = _tables(b, seeds)
    carry = _carry0(b, K)
    sc = {"t_sr": float(policy.t_sr), "overrun_prob": float(overrun_prob),
          "cf": float(cf), "duration": float(duration),
          "max_steps": _max_steps(b, duration)}
    step = _build_step(policy.use_banks, policy.drop_lo_in_hi,
                       policy.preemption, nominal, _PRUNE_STALE, loop_scen)
    r = _Runner(step, tb, carry, dev, 1)
    with r._on_stream():
        r._load(tb, sc, carry)
        graph = r._capture(tb, sc, carry, debug=True,
                           body=lambda: step(r.tb, r.sc, r.c, r.k))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "step.dot")
        graph.debug_dump(path)
        with open(path) as f:
            return while_body_kernels(f.read())


def metrics_digest(metrics: Sequence[RunMetrics]) -> str:
    """sha256 over every field of every row, floats as ``float.hex``
    (bit-exact), in order: the pin the card's rows are held to.  A
    sample list (the event and vec engines') is hashed as its sum and
    count, summed in event order as ``metrics_row`` does, so rows that
    ``metrics_row`` flattens equally hash equally whichever engine made
    them."""
    h = hashlib.sha256()
    for m in metrics:
        fields = []
        for name in ("pi_blocking", "ci_blocking", "save_cycles",
                     "restore_cycles"):
            agg = getattr(m, name)
            if isinstance(agg, list):
                agg = AggSamples(float(sum(agg)), len(agg))
            fields += [float(agg.total).hex(), str(int(agg.n))]
        for name in ("jobs", "done", "misses", "misses_by_mode"):
            d = getattr(m, name)
            fields += [f"{k}={int(d[k])}" for k in sorted(d)]
        fields += [f"{k}={float(v).hex()}"
                   for k, v in sorted(m.mode_cycles.items())]
        fields += [str(int(m.lo_released_in_hi)), str(int(m.lo_done_in_hi)),
                   str(int(m.cs_count)), float(m.exec_cycles).hex(),
                   float(m.overhead_cycles).hex()]
        h.update((";".join(fields) + "\n").encode())
    return h.hexdigest()
