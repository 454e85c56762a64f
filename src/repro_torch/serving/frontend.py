"""Admission-control front door + open-loop drive for MESC serving (twin
of the reference's ``serving/frontend.py``, bound to the port's
``core.serving``).

  * :class:`FrontDoor` — the admission queue.  HI requests always drain
    before LO requests, and an optional ``max_live_lo`` cap bounds
    concurrent LO admissions so overload queues at the door instead of
    thrashing the KV arena.  Conservation invariant: ``finished + live
    + queued == submitted`` at every instant.
  * :class:`VirtualModel` — the deterministic stand-in for the model's
    (decode, prefill) pair: instead of running a model it advances its
    lane's ``VirtualClock`` by a CRN-drawn service time keyed ``(seed,
    stream, rid, step)``, so two policies serve the same workload with
    the same per-token service realization.  It runs on the host and
    touches no device.
  * :func:`run_virtual_serving` — the open-loop drive on virtual time:
    admits arrivals against the global frontier (the minimum over busy
    lanes' clocks, idle lanes ridden forward so admission stays causal),
    steps the earliest busy lane, and returns the request set for
    ``slo.slo_summary``.

Every request row and SLO row it produces is bit-equal to the
reference's: the serving loop is the reference's, statement for
statement (the same ``deque``/``sorted`` order and the same float
operations).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.scheduler import Policy
from repro_torch.core.serving import MultiLaneServer, Request
from repro_torch.core.task import Crit
from repro_torch.runtime import trace
from repro_torch.scenarios import (get_scenario, lane_lost,
                                   next_loss_boundary)
from repro_torch.serving.clock import VirtualClock
from repro_torch.serving.traffic import ArrivalSpec, crn_u01

#: Per-request decode-step key stride: step k of request rid draws at
#: counter index rid * _RID_STRIDE + k (bounds max_new_tokens).
_RID_STRIDE = 1 << 20


def make_request(spec: ArrivalSpec, *, vocab: int = 256) -> Request:
    """One :class:`~repro_torch.core.serving.Request` from a traffic
    spec.  The one-token prompt carries the rid so the
    :class:`VirtualModel` can key its service draws per request;
    ``submitted_at`` is pre-stamped with the true arrival time, so
    queueing at the front door is part of measured latency."""
    del vocab                               # shape knob reserved for real
    return Request(rid=spec.rid,            # prompts; rid prompt is exact
                   prompt=np.asarray([spec.rid], np.int32),
                   max_new_tokens=spec.max_new_tokens,
                   priority=spec.priority, crit=spec.crit,
                   lo_budget_s=spec.lo_budget_s,
                   submitted_at=spec.t)


class VirtualModel:
    """Deterministic (decode, prefill) pair for one dispatch lane.

    Each call advances the lane's :class:`VirtualClock` by a service
    time drawn from the counter-based CRN — decode step ``k`` of
    request ``rid`` costs ``decode_mean_s * (1 +- jitter)`` with the
    uniform jitter keyed ``(seed, 'svc_decode', rid * stride + k)``,
    prefill ``prefill_mean_s`` likewise.  The "KV cache" is a plain
    dict carrying (rid, pos, k); generated tokens are CRN draws too,
    returned as one-hot CPU logits for the server's ``argmax``."""

    def __init__(self, clock: VirtualClock, *, seed: int,
                 decode_mean_s: float = 0.010,
                 prefill_mean_s: float = 0.020,
                 jitter: float = 0.25, vocab: int = 256):
        if not 0.0 <= jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {jitter}")
        if min(decode_mean_s, prefill_mean_s) <= 0:
            raise ValueError("service means must be > 0")
        self.clock = clock
        self.seed = seed
        self.decode_mean_s = decode_mean_s
        self.prefill_mean_s = prefill_mean_s
        self.jitter = jitter
        self.vocab = vocab

    def _service(self, stream: str, idx: int, mean: float) -> float:
        u = float(crn_u01(self.seed, stream, idx))
        return mean * (1.0 + self.jitter * (2.0 * u - 1.0))

    def prefill(self, params, batch):
        del params
        tokens = batch["tokens"]
        rid = int(tokens[0, 0])
        self.clock.advance(self._service("svc_prefill", rid,
                                         self.prefill_mean_s))
        return None, {"rid": rid, "pos": int(tokens.shape[1]), "k": 0}

    def decode(self, params, tok, cache):
        del params, tok                     # service keyed by (rid, k)
        rid, k = int(cache["rid"]), int(cache["k"])
        idx = rid * _RID_STRIDE + k
        self.clock.advance(self._service("svc_decode", idx,
                                         self.decode_mean_s))
        tok_out = int(crn_u01(self.seed, "tok", idx) * self.vocab)
        logits = torch.zeros((1, self.vocab), dtype=torch.float32)
        logits[0, tok_out] = 1.0
        return logits, {"rid": rid, "pos": int(cache["pos"]) + 1,
                        "k": k + 1}

    @property
    def jit_fns(self):
        """(decode, prefill) in ``MESCServer``'s expected order."""
        return (self.decode, self.prefill)


# ----------------------------------------------------------------------
class FrontDoor:
    """Admission control between the arrival stream and the server.

    ``arrive`` enqueues (HI and LO queues, each FIFO); ``pump`` admits
    while capacity allows — HI first, always, then LO up to
    ``max_live_lo`` concurrently live LO requests (``None`` = open
    throttle).  HI requests are never capped."""

    def __init__(self, server, *, max_live_lo: Optional[int] = None,
                 make_request_fn: Callable[[ArrivalSpec], Request]
                 = make_request):
        if max_live_lo is not None and max_live_lo < 1:
            raise ValueError(f"max_live_lo must be >= 1 or None, "
                             f"got {max_live_lo}")
        self.server = server
        self.max_live_lo = max_live_lo
        self._make = make_request_fn
        self.hi_q: Deque[ArrivalSpec] = deque()
        self.lo_q: Deque[ArrivalSpec] = deque()
        self.submitted = 0                 # arrived at the door, ever

    # -- conservation accounting (finished + live + queued == submitted)
    @property
    def queued(self) -> int:
        return len(self.hi_q) + len(self.lo_q)

    def live(self) -> int:
        return sum(1 for r in self.server.requests.values() if not r.done)

    def finished(self) -> int:
        return sum(1 for r in self.server.requests.values() if r.done)

    def check_conservation(self) -> None:
        total = self.finished() + self.live() + self.queued
        if total != self.submitted:
            raise AssertionError(
                f"request conservation violated: finished "
                f"{self.finished()} + live {self.live()} + queued "
                f"{self.queued} != submitted {self.submitted}")

    def _live_lo(self) -> int:
        return sum(1 for r in self.server.requests.values()
                   if not r.done and r.crit == Crit.LO)

    def arrive(self, spec: ArrivalSpec) -> None:
        self.submitted += 1
        (self.hi_q if spec.crit == Crit.HI else self.lo_q).append(spec)

    def pump(self) -> List[int]:
        """Admit everything currently admissible; returns the admitted
        rids (HI strictly before LO).  While the tracer is on, a span
        ``serve.pump`` with the count admitted."""
        if not trace.ON:
            return self._admit()
        with trace.span("serve.pump") as sp:
            admitted = self._admit()
            sp.attrs["admitted"] = len(admitted)
        return admitted

    def _admit(self) -> List[int]:
        admitted: List[int] = []
        while self.hi_q:                   # HI is never throttled
            spec = self.hi_q.popleft()
            self.server.submit(self._make(spec))
            admitted.append(spec.rid)
        while self.lo_q:
            if (self.max_live_lo is not None
                    and self._live_lo() >= self.max_live_lo):
                break
            spec = self.lo_q.popleft()
            self.server.submit(self._make(spec))
            admitted.append(spec.rid)
        return admitted


# ----------------------------------------------------------------------
# The open-loop virtual-time drive
# ----------------------------------------------------------------------

def _lane_live(lane) -> bool:
    return any(not r.done for r in lane.requests.values())


def drive_open_loop(server: MultiLaneServer,
                    clocks: Sequence[VirtualClock],
                    workload: Sequence[ArrivalSpec],
                    front: FrontDoor, *,
                    max_steps: int = 5_000_000,
                    scenario=None, seed: int = 0,
                    on_step: Optional[Callable[[FrontDoor, Any], None]]
                    = None) -> Dict[int, Request]:
    """Serve an open-loop workload to completion on the virtual clock.

    Arrivals are admitted only up to the *frontier* — the clock of the
    earliest busy lane — and idle lanes are ridden forward to the
    frontier before admission, so no lane serves a request dated after
    its own local time.  The earliest busy lane then takes one
    instruction (= decode step); on an empty system all clocks jump to
    the next arrival.  ``on_step`` observes the front door after every
    iteration.

    A ``scenario`` with the instance-loss component shrinks the live
    lane set: a lane inside a keyed outage window (``lane_lost``)
    neither starts new work (``server.blocked_lanes`` steers the
    partitioner away) nor steps.  When no lane is steppable, all clocks
    jump to the next arrival or outage-window boundary, and admission
    is held while every lane is lost.  With ``scenario=None`` (or a
    scenario without the loss component) the loop is the scenario-free
    one.
    """
    scen = get_scenario(scenario)
    if scen is not None and not scen.has_loss:
        scen = None        # only instance loss acts at the serving layer
    pending = deque(sorted(workload, key=lambda s: (s.t, s.rid)))
    lanes = server.lanes
    for _ in range(max_steps):
        busy = [i for i, ln in enumerate(lanes) if _lane_live(ln)]
        if not busy and not pending and not front.queued:
            break
        if scen is not None:
            lost = {j for j in range(len(lanes))
                    if lane_lost(scen, seed, j, clocks[j]())}
            server.blocked_lanes = lost
            steppable = [j for j in busy if j not in lost]
        else:
            lost = set()
            steppable = busy
        if steppable:
            i = min(steppable, key=lambda j: (clocks[j](), j))
            now = clocks[i]()
            for j, ln in enumerate(lanes):      # idle and lost lanes
                if j not in steppable:          # ride along
                    clocks[j].advance_to(now)
            while pending and pending[0].t <= now:
                front.arrive(pending.popleft())
            front.pump()
            lanes[i].step()
            front.pump()                        # a finish frees capacity
        else:
            # nothing steppable: jump to the next instant anything can
            # change — the next arrival, or (with work stalled behind
            # an outage) the next loss-window boundary
            t = pending[0].t if pending else np.inf
            if scen is not None and (busy or front.queued):
                t = min(t, next_loss_boundary(
                    scen, min(c() for c in clocks)))
            for c in clocks:
                c.advance_to(t)
            while pending and pending[0].t <= t:
                front.arrive(pending.popleft())
            if scen is not None:
                lost = {j for j in range(len(lanes))
                        if lane_lost(scen, seed, j, clocks[j]())}
                server.blocked_lanes = lost
            if len(lost) < len(lanes):          # hold admission while
                front.pump()                    # every lane is lost
        if on_step is not None:
            on_step(front, server)
    else:
        raise RuntimeError(
            f"open-loop drive exceeded max_steps={max_steps} with "
            f"{front.queued} queued / {front.live()} live requests — "
            "raise max_steps or shrink the workload")
    front.check_conservation()
    return server.requests


def run_virtual_serving(workload: Sequence[ArrivalSpec], *,
                        lanes: int = 1, policy: Optional[Policy] = None,
                        seed: int = 0,
                        decode_mean_s: float = 0.010,
                        prefill_mean_s: float = 0.020,
                        jitter: float = 0.25,
                        cs_save_s: float = 0.004,
                        cs_restore_s: float = 0.004,
                        heuristic: str = "crit_aware",
                        slots_per_lane: int = 2,
                        max_live_lo: Optional[int] = None,
                        max_steps: int = 5_000_000,
                        scenario=None,
                        on_step: Optional[Callable] = None,
                        ) -> Dict[int, Request]:
    """One deterministic serving run: workload in, request set out
    (feed it to ``slo.slo_summary``).

    Builds one :class:`VirtualClock` + :class:`VirtualModel` per lane, a
    shared-arena :class:`~repro_torch.core.serving.MultiLaneServer` with
    no parameters (so on the host), and an admission
    :class:`FrontDoor`, then drives the open loop.  Same (workload,
    seed, policy knobs) -> the same request timelines, bit for bit.
    """
    vclocks = [VirtualClock() for _ in range(lanes)]
    models = [VirtualModel(c, seed=seed, decode_mean_s=decode_mean_s,
                           prefill_mean_s=prefill_mean_s, jitter=jitter)
              for c in vclocks]
    max_tokens = max((s.max_new_tokens for s in workload), default=1)
    server = MultiLaneServer(
        None, None, n_lanes=lanes, policy=policy,
        max_len=max_tokens + 8,
        total_slots=slots_per_lane * lanes, heuristic=heuristic,
        jit_fns=[m.jit_fns for m in models], clocks=vclocks,
        cs_costs=(cs_save_s, cs_restore_s))
    front = FrontDoor(server, max_live_lo=max_live_lo)
    return drive_open_loop(server, vclocks, workload, front,
                           max_steps=max_steps, scenario=scenario,
                           seed=seed, on_step=on_step)


@dataclasses.dataclass(frozen=True)
class ServiceModelSpec:
    """The virtual service-time knobs as one JSON-able bundle."""
    decode_mean_s: float = 0.010
    prefill_mean_s: float = 0.020
    jitter: float = 0.25
    cs_save_s: float = 0.004
    cs_restore_s: float = 0.004

    def lane_capacity_rps(self, mean_tokens: float) -> float:
        """Requests/s one lane sustains at ``mean_tokens`` per request
        (the saturation anchor fig12's offered-load axis scales on)."""
        return 1.0 / (self.prefill_mean_s
                      + mean_tokens * self.decode_mean_s)
