"""MESC-scheduled model serving on the card (twin of the reference's
``core/serving.py``).

Mapping (the paper's accelerator onto one GPU):
  * accelerator instruction  = one decode step / one prefill
  * scratchpad banks         = a bounded pool of device-resident KV-cache
                               slots; the bank allocator decides which
                               requests stay resident
  * context save / restore   = moving a request's cache dict to / from
                               host memory (step_wise_mvout/mvin analogue)
  * task monitor             = LO-budget timers -> mode switch

Every timestamp is read through an injected *clock* (default
``time.monotonic``), and ``jit_fns`` / ``cs_costs`` keep the reference's
injection points, so a modelless (decode, prefill) pair and a virtual
clock drive the same scheduling code.  The scheduling code is the
reference's line for line; only the model calls and the cache moves are
PyTorch.  HI requests preempt LO requests at decode-step boundaries; LO
requests are never dropped.

:class:`MultiLaneServer` runs one :class:`MESCServer` dispatch lane per
virtual accelerator, all drawing KV-cache residency from one shared
:class:`KVSlotArena` carved into per-lane quotas.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.scheduler import MODE_SEVERITY, Mode, Policy
from repro_torch.core.task import Crit
from repro_torch.models import lm
from repro_torch.models.common import CPU_RC, RuntimeConfig
from repro_torch.runtime import trace

# request -> lane partition heuristics (the reference's core.platform)
HEURISTICS = ("first_fit", "worst_fit", "crit_aware")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int
    priority: int
    crit: Crit
    lo_budget_s: float = 1e9        # LO-WCET analogue (wall clock)
    # runtime state
    generated: List[int] = dataclasses.field(default_factory=list)
    cache: Optional[dict] = None    # device (resident) or host (saved)
    resident: bool = False
    done: bool = False
    started_at: Optional[float] = None
    exec_s: float = 0.0
    first_token_at: Optional[float] = None
    submitted_at: Optional[float] = None
    finished_at: Optional[float] = None
    preemptions: int = 0
    saves: int = 0


class KVSlotArena:
    """Shared pool of device-resident KV-cache slots, carved into
    per-lane quotas (``sum(quotas) == total``), so each lane's admission
    check is local."""

    def __init__(self, total_slots: int, n_lanes: int = 1,
                 quotas: Optional[List[int]] = None):
        if quotas is None:
            base, rem = divmod(total_slots, n_lanes)
            quotas = [base + (1 if i < rem else 0) for i in range(n_lanes)]
        if len(quotas) != n_lanes or sum(quotas) != total_slots:
            raise ValueError(f"quotas {quotas} must partition "
                             f"{total_slots} slots over {n_lanes} lanes")
        if min(quotas) < 1:
            raise ValueError(f"every lane needs >= 1 slot, got {quotas}")
        self.total_slots = total_slots
        self.quotas = list(quotas)
        self._held: List[set] = [set() for _ in range(n_lanes)]

    def held(self, lane: int) -> int:
        return len(self._held[lane])

    def can_admit(self, lane: int) -> bool:
        return self.held(lane) < self.quotas[lane]

    def acquire(self, lane: int, rid: int) -> None:
        if rid not in self._held[lane] and not self.can_admit(lane):
            raise RuntimeError(f"lane {lane} over quota "
                               f"({self.quotas[lane]} slots)")
        self._held[lane].add(rid)

    def release(self, lane: int, rid: int) -> None:
        self._held[lane].discard(rid)


def _move_cache(cache: dict, device) -> dict:
    """Every tensor of a (nested) cache dict on ``device``, as the
    reference's ``jax.device_get`` / ``device_put`` move the whole pytree
    (the hybrid cache nests its tail layers' states under ``"tail"``)."""
    return {k: (_move_cache(v, device) if isinstance(v, dict)
                else v.to(device) if isinstance(v, torch.Tensor) else v)
            for k, v in cache.items()}


def _cache_bytes(cache: dict) -> int:
    return sum(_cache_bytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size()
               if isinstance(v, torch.Tensor) else 0
               for v in cache.values())


def _moved(kind: str, r: "Request", device) -> dict:
    """``r``'s cache moved to ``device`` through the module global
    ``_move_cache``, inside a span ``serve.<kind>`` with its counters
    while the tracer is on."""
    if not trace.ON:
        return _move_cache(r.cache, device)
    n = _cache_bytes(r.cache)
    trace.count(f"serve.{kind}s")
    trace.count(f"serve.{kind}_bytes", n)
    with trace.span(f"serve.{kind}", rid=r.rid, bytes=n):
        return _move_cache(r.cache, device)


def model_fns(cfg: ArchConfig, rc: RuntimeConfig, max_len: int):
    """The (decode, prefill) pair the server dispatches: the port's
    ``lm.decode_step`` and ``lm.prefill`` (the reference jits both; here
    a prefill runs eagerly and, on the card, a decode step replays a CUDA
    graph: ``models/decode_graph.py``)."""
    def decode(p, t, c):
        return lm.decode_step(cfg, p, t, c, rc)

    def prefill(p, b):
        return lm.prefill(cfg, p, b, rc, max_len=max_len)
    return decode, prefill


def _params_device(params):
    if isinstance(params, dict):
        return params["embed"].device
    return torch.device("cpu")          # modelless drive: no parameters


class MESCServer:
    """Single-model mixed-criticality serving loop (batch size 1 per
    request; the accelerator — one dispatch lane — is the shared
    resource).  Standalone it owns a private one-lane arena sized
    ``resident_slots``; under :class:`MultiLaneServer` it is one lane of
    a shared arena."""

    def __init__(self, cfg: ArchConfig, params, *, policy: Policy = None,
                 rc: RuntimeConfig = CPU_RC, max_len: int = 64,
                 resident_slots: int = 2,
                 arena: Optional[KVSlotArena] = None, lane: int = 0,
                 jit_fns=None,
                 clock: Callable[[], float] = time.monotonic,
                 cs_costs: Optional[Tuple[float, float]] = None):
        self.cfg = cfg
        self.params = params
        self.rc = rc
        self.policy = policy or Policy.mesc()
        self.max_len = max_len
        self.arena = arena or KVSlotArena(resident_slots, 1)
        self.lane = lane
        self.mode = Mode.LO
        self.requests: Dict[int, Request] = {}
        self.current: Optional[int] = None
        self.clock = clock
        self._cs_save_s, self._cs_restore_s = cs_costs or (0.0, 0.0)
        self.device = _params_device(params)
        if jit_fns is not None:            # shared across lanes
            self._decode, self._prefill = jit_fns
        else:
            self._decode, self._prefill = model_fns(cfg, rc, max_len)

    def _charge(self, dt: float) -> None:
        """Charge a modeled context-switch cost to an advanceable
        (virtual) clock; a wall clock pays the real save/restore
        latency through the copies themselves, so this is a no-op."""
        adv = getattr(self.clock, "advance", None)
        if adv is not None and dt:
            adv(dt)

    # -- bank pool ----------------------------------------------------------
    def _resident(self) -> List[Request]:
        return [r for r in self.requests.values()
                if r.resident and not r.done]

    def _evict(self, victim: Request):
        victim.cache = _moved("save", victim, "cpu")  # step_wise_mvout
        victim.resident = False
        victim.saves += 1
        self._charge(self._cs_save_s)
        self.arena.release(self.lane, victim.rid)

    def _make_room(self, incoming: Request):
        """Evict (context-save) lowest-priority resident request if the
        lane's quota is full — zero work when a slot is free (Obs. 1)."""
        res = [r for r in self._resident() if r.rid != incoming.rid]
        while res and not self.arena.can_admit(self.lane):
            victim = max(res, key=lambda r: r.priority)
            self._evict(victim)
            res.remove(victim)

    def _restore(self, r: Request):
        self.arena.acquire(self.lane, r.rid)
        if r.cache is None:
            # the prefill logits are dropped, as in the reference: the
            # first decode step feeds prompt[-1] again at position S
            with trace.span("serve.prefill", rid=r.rid, crit=r.crit.value,
                            tokens=len(r.prompt)) \
                    if trace.ON else trace.NULL:
                _, r.cache = self._prefill(
                    self.params,
                    {"tokens": torch.as_tensor(r.prompt[None],
                                               device=self.device)})
        elif not r.resident:
            r.cache = _moved("restore", r, self.device)  # step_wise_mvin
            self._charge(self._cs_restore_s)
        r.resident = True

    # -- scheduling ---------------------------------------------------------
    def submit(self, r: Request):
        if r.submitted_at is None:         # front door may pre-stamp the
            r.submitted_at = self.clock()  # true arrival time
        self.requests[r.rid] = r

    def _eligible(self) -> List[Request]:
        live = [r for r in self.requests.values() if not r.done]
        his = [r for r in live if r.crit == Crit.HI]
        out = []
        for r in live:
            if r.crit == Crit.HI or self.mode == Mode.LO:
                out.append(r)
            elif self.policy.drop_lo_in_hi:
                continue
            elif his:
                continue                   # LO only when no HI active
            else:
                out.append(r)
        return out

    def _pick(self) -> Optional[Request]:
        el = self._eligible()
        if not el:
            live = [r for r in self.requests.values() if not r.done]
            return min(live, key=lambda r: r.priority) if live else None
        return min(el, key=lambda r: r.priority)

    def eligible_order(self) -> List[Request]:
        """The lane's service order right now: eligible requests sorted
        the way successive ``_pick`` calls would drain them (priority,
        rid tiebreak), with a non-preemptive owner pinned first."""
        el = sorted(self._eligible(), key=lambda r: (r.priority, r.rid))
        if self.policy.preemption == "none" and self.current is not None:
            cur = self.requests.get(self.current)
            if cur is not None and not cur.done:
                el = [cur] + [r for r in el if r.rid != cur.rid]
        return el

    def _mode_tick(self):
        live = [r for r in self.requests.values() if not r.done]
        if not live:
            self.mode = Mode.LO            # idle -> revert
            return
        for r in live:                     # monitor: LO-budget timers
            # ANY request overrunning its LO-criticality budget trips
            # the switch (the reference's rule, see its docstring)
            if r.exec_s > r.lo_budget_s and self.mode == Mode.LO:
                self.mode = Mode.HI

    # -- the serve loop -----------------------------------------------------
    def step(self) -> Optional[int]:
        """One scheduler invocation + one instruction (decode step).
        Returns the rid that ran, or None if idle.  While the tracer is
        on, the step is a span ``serve.step``."""
        if not trace.ON:
            return self._step()
        mode = self.mode
        with trace.span("serve.step", lane=self.lane) as sp:
            sp.rid = self._step()
        if self.mode != mode:
            trace.count("serve.mode_switches")
        return sp.rid

    def _step(self) -> Optional[int]:
        self._mode_tick()
        r = self._pick()
        # non-preemptive baseline: a started request owns the accelerator
        if (self.policy.preemption == "none" and self.current is not None):
            cur = self.requests.get(self.current)
            if cur is not None and not cur.done:
                r = cur
        if r is None:
            return None
        if r.rid != self.current and self.current is not None:
            prev = self.requests.get(self.current)
            if prev is not None and not prev.done:
                prev.preemptions += 1
                if trace.ON:
                    trace.count("serve.preemptions")
        self.current = r.rid
        if not r.resident:
            self._make_room(r)
            self._restore(r)
        if r.started_at is None:
            r.started_at = self.clock()
        t0 = self.clock()
        last = (r.generated[-1] if r.generated else int(r.prompt[-1]))
        with trace.span("serve.decode", rid=r.rid, pos=r.cache["pos"]) \
                if trace.ON else trace.NULL:
            logits, r.cache = self._decode(
                self.params,
                torch.tensor([last], dtype=torch.int32, device=self.device),
                r.cache)
        # the step's one wait for the card
        with trace.span("serve.readback", rid=r.rid) \
                if trace.ON else trace.NULL:
            tok = int(torch.argmax(logits[0].float()))
        r.generated.append(tok)
        r.exec_s += self.clock() - t0
        if r.first_token_at is None:
            r.first_token_at = self.clock()
        if len(r.generated) >= r.max_new_tokens \
                or int(r.cache["pos"]) >= self.max_len - 1:
            r.done = True
            r.finished_at = self.clock()
            r.resident = False
            r.cache = None                 # flush banks
            self.arena.release(self.lane, r.rid)
            self.current = None
        return r.rid

    def run(self, max_steps: int = 10_000) -> Dict[int, Request]:
        for _ in range(max_steps):
            if self.step() is None:
                break
        return self.requests


# ----------------------------------------------------------------------
# Multi-accelerator serving: one dispatch lane per virtual accelerator
# ----------------------------------------------------------------------

class MultiLaneServer:
    """Partitioned MESC serving over N virtual accelerator lanes.

    Each lane is a full :class:`MESCServer` with its own mode machine,
    policy and slice of the shared :class:`KVSlotArena`; all lanes share
    one (decode, prefill) pair.  Requests are partitioned onto lanes at
    submit time: ``crit_aware`` spreads HI requests and steers LO
    requests toward HI-light lanes, ``worst_fit`` balances live-request
    counts, ``first_fit`` packs.  ``step()`` advances every lane by one
    instruction, so lanes progress in lockstep rounds.
    """

    def __init__(self, cfg: ArchConfig, params, *, n_lanes: int = 2,
                 policy: Policy = None, rc: RuntimeConfig = CPU_RC,
                 max_len: int = 64, total_slots: Optional[int] = None,
                 heuristic: str = "crit_aware", jit_fns=None,
                 clocks: Optional[Sequence[Callable[[], float]]] = None,
                 cs_costs: Optional[Tuple[float, float]] = None):
        if heuristic not in HEURISTICS:
            raise ValueError(f"unknown heuristic {heuristic!r}")
        total_slots = total_slots if total_slots is not None else 2 * n_lanes
        self.arena = KVSlotArena(total_slots, n_lanes)
        self.heuristic = heuristic
        if jit_fns is None:
            per_lane_fns = [model_fns(cfg, rc, max_len)] * n_lanes
        elif callable(jit_fns[0]):                     # one shared pair
            per_lane_fns = [tuple(jit_fns)] * n_lanes
        else:                                          # per-lane pairs
            if len(jit_fns) != n_lanes:
                raise ValueError(f"got {len(jit_fns)} jit_fns pairs "
                                 f"for {n_lanes} lanes")
            per_lane_fns = [tuple(fns) for fns in jit_fns]
        if clocks is None:
            per_lane_clocks: List[Callable[[], float]] = \
                [time.monotonic] * n_lanes
        elif callable(clocks):                         # one shared clock
            per_lane_clocks = [clocks] * n_lanes
        else:
            if len(clocks) != n_lanes:
                raise ValueError(f"got {len(clocks)} clocks for "
                                 f"{n_lanes} lanes")
            per_lane_clocks = list(clocks)
        self.lanes: List[MESCServer] = [
            MESCServer(cfg, params, policy=policy, rc=rc, max_len=max_len,
                       arena=self.arena, lane=i, jit_fns=per_lane_fns[i],
                       clock=per_lane_clocks[i], cs_costs=cs_costs)
            for i in range(n_lanes)]
        self.lane_of: Dict[int, int] = {}
        self.blocked_lanes: set = set()

    # -- request -> lane partitioning ---------------------------------------
    def _live(self, lane: MESCServer, crit: Optional[Crit] = None) -> int:
        return sum(1 for r in lane.requests.values() if not r.done
                   and (crit is None or r.crit == crit))

    def _assign(self, r: Request) -> int:
        n = len(self.lanes)
        cand = [i for i in range(n) if i not in self.blocked_lanes] \
            or list(range(n))
        if self.heuristic == "first_fit":
            return next((i for i in cand
                         if self._live(self.lanes[i]) < self.arena.quotas[i]),
                        min(cand,
                            key=lambda i: self._live(self.lanes[i])))
        if self.heuristic == "worst_fit":
            return min(cand, key=lambda i: self._live(self.lanes[i]))
        if r.crit == Crit.HI:
            return min(cand,
                       key=lambda i: (self._live(self.lanes[i], Crit.HI),
                                      self._live(self.lanes[i])))
        return min(cand,
                   key=lambda i: self._live(self.lanes[i], Crit.LO)
                   + 2 * self._live(self.lanes[i], Crit.HI))

    def submit(self, r: Request) -> int:
        lane = self._assign(r)
        self.lane_of[r.rid] = lane
        self.lanes[lane].submit(r)
        return lane

    # -- the serve loop -----------------------------------------------------
    def step(self) -> List[Optional[int]]:
        """One lockstep round: each lane runs one scheduler invocation
        + one instruction.  Returns the rid that ran per lane."""
        return [lane.step() for lane in self.lanes]

    def run(self, max_steps: int = 10_000) -> Dict[int, Request]:
        for _ in range(max_steps):
            if all(r is None for r in self.step()):
                break
        return self.requests

    @property
    def requests(self) -> Dict[int, Request]:
        out: Dict[int, Request] = {}
        for lane in self.lanes:
            out.update(lane.requests)
        return out

    def platform_mode(self) -> Mode:
        return max((lane.mode for lane in self.lanes),
                   key=MODE_SEVERITY.__getitem__)
