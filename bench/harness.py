"""One run of a cell: set-up (weights from the seed, warm-up of the cell's
own shapes), the measured window, the correctness check and the result.

The window drives the program's serving entry: ``MESCServer`` (one lane)
behind ``FrontDoor``.  The loop below releases requests on the mix's
schedule, calls ``FrontDoor.arrive`` and ``pump``, and steps the server
while anything is live; its timing is that of the port's
``launch/serve.py::run_traffic_real``.  The model's (decode, prefill)
reach the server through its ``jit_fns`` injection point, as wrappers
around ``lm.decode_step`` and ``lm.prefill`` that record spans; the
context moves, the expert layer and the flash attention wrapper are
wrapped where the program looks them up (``core.serving._move_cache``,
``models.ffn.moe_dispatch``, ``models.attention.flash_attention``).

A traced run synchronises the card at both ends of every wrapped call,
times the expert layer and the flash attention wrapper inside each
prefill between CUDA events, and profiles the window's last seconds; the
end-to-end metrics come from untraced runs.
"""
from __future__ import annotations

import contextlib
import gc
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from bench import check, generator, weights
from bench.trace import Profiler, Slice

LO_BASE = 1_000_000     # LO rids and priorities lie above every HI's
GRACE_S = 60.0          # the wait, past the close, for HI due in the window
SLICE_S = 3.0           # profiled slice at the window's end, seconds


def arch_config(prog: dict):
    from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig
    kw = dict(prog)
    if kw.get("mla"):
        kw["mla"] = MLAConfig(**kw["mla"])
    if kw.get("moe"):
        kw["moe"] = MoEConfig(**kw["moe"])
    return ArchConfig(**kw)


def runtime_config(serve: dict):
    from repro_torch.models.common import RuntimeConfig
    return RuntimeConfig(compute_dtype=weights.DTYPES[serve["compute_dtype"]],
                         dus_cache_update=serve["dus_cache_update"])


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


@dataclass
class Run:
    """What a run measured, for the metric readers.  Times are seconds
    after the window opened (the first due request)."""
    conf: dict
    traffic: dict
    seconds: float
    setup_s: float
    device_kind: str
    # spans before this time are free of the profiler (the window's end
    # when untraced)
    clean_s: float = 0.0
    requests: List[dict] = field(default_factory=list)
    spans: List[dict] = field(default_factory=list)
    steps: List[tuple] = field(default_factory=list)  # (start, s, rid)
    trace: Optional[Slice] = None


class Recorder:
    """The wrapped model calls; ``spans`` holds one dict a call."""

    def __init__(self, cfg, rc, max_len: int, traced: bool,
                 clock: Callable[[], float]):
        self.cfg, self.rc, self.max_len = cfg, rc, max_len
        self.traced, self.clock = traced, clock
        self.spans: List[dict] = []
        self.server = None
        # CUDA events around the wrapped layers inside a traced prefill
        self._events: Optional[dict] = None

    def _sync(self):
        if self.traced:
            torch.cuda.synchronize()

    def _request(self):
        return self.server.requests[self.server.current]

    def prefill(self, params, batch):
        from repro_torch.models import lm
        r = self._request()
        S = int(batch["tokens"].shape[1])
        crit = r.crit.value
        self._sync()
        self._events = {"moe": [], "flash": []} if self.traced else None
        t0 = self.clock()
        out = lm.prefill(self.cfg, params, batch, self.rc,
                         max_len=self.max_len)
        self._sync()
        span = dict(kind="prefill", rid=r.rid, crit=crit, tokens=S, t0=t0,
                    t1=self.clock())
        for name, evs in (self._events or {}).items():
            if evs:
                span[f"{name}_s"] = sum(a.elapsed_time(b)
                                        for a, b in evs) / 1e3
        self._events = None
        self.spans.append(span)
        return out

    def decode(self, params, tok, cache):
        from repro_torch.models import lm
        pos = int(cache["pos"])
        self._sync()
        t0 = self.clock()
        out = lm.decode_step(self.cfg, params, tok, cache, self.rc)
        self._sync()
        if self.traced:
            self.spans.append(dict(kind="decode", rid=self.server.current,
                                   pos=pos, t0=t0, t1=self.clock()))
        return out

    def _timed(self, name: str, fn):
        """``fn`` between two CUDA events while a traced prefill runs."""
        def call(*args, **kw):
            if self._events is None:
                return fn(*args, **kw)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            self._events[name].append((a, b))
            return out
        return call

    @contextlib.contextmanager
    def installed(self):
        """The context moves (and, traced, the expert layer and the flash
        attention wrapper) wrapped where the program looks them up, for
        the duration of the block."""
        from repro_torch.core import serving as serving_mod
        from repro_torch.models import attention, ffn
        move = serving_mod._move_cache
        moe, flash = ffn.moe_dispatch, attention.flash_attention

        def move_cache(cache, device):
            kind = "save" if torch.device(device).type == "cpu" else "restore"
            self._sync()
            t0 = self.clock()
            out = move(cache, device)
            self._sync()
            self.spans.append(dict(kind=kind, bytes=_tree_bytes(cache),
                                   t0=t0, t1=self.clock()))
            return out

        serving_mod._move_cache = move_cache
        if self.traced:
            ffn.moe_dispatch = self._timed("moe", moe)
            attention.flash_attention = self._timed("flash", flash)
        try:
            yield
        finally:
            serving_mod._move_cache = move
            ffn.moe_dispatch, attention.flash_attention = moe, flash


def _request_fn(prompts: dict, t0: float):
    from repro_torch.core.serving import Request

    def make(spec):
        return Request(rid=spec.rid, prompt=prompts.pop(spec.rid),
                       max_new_tokens=spec.max_new_tokens,
                       priority=spec.priority, crit=spec.crit,
                       lo_budget_s=spec.lo_budget_s,
                       submitted_at=t0 + spec.t)
    return make


def _warm_up(server, work: generator.Workload, traffic: dict):
    """One LO document and one HI request through the server, the HI
    arriving after the document's first step: every shape the window
    uses (the LO prefill and its decode positions, the HI prefill and
    decode step, and where one slot is resident a save and a restore)."""
    from repro_torch.core.serving import Request
    from repro_torch.core.task import Crit
    lo, hi = work.warm_prompts()
    server.submit(Request(rid=-2, prompt=lo, priority=LO_BASE - 1,
                          max_new_tokens=traffic["lo"]["max_new_tokens"],
                          crit=Crit.LO))
    server.step()
    server.submit(Request(rid=-1, prompt=hi, priority=-1,
                          max_new_tokens=traffic["hi"]["max_new_tokens"],
                          crit=Crit.HI))
    server.run()
    server.requests.clear()


def serve_window(server, work: generator.Workload, traffic: dict, clock,
                 profiler: Optional[Profiler] = None):
    """The measured window and its close.

    HI releases go on past the close on the same schedule until every HI
    due in the window is done and every LO document that had begun before
    the close has finished, so that document finishes under the same
    load (at most ``GRACE_S`` more).  A traced run profiles the window's
    last seconds.  Returns (t0, LO documents sent, HI due, steps, the
    window time the profiler started at)."""
    from repro_torch.core.task import Crit
    from repro_torch.serving.frontend import FrontDoor
    from repro_torch.serving.traffic import ArrivalSpec
    seconds = work.seconds
    prompts: dict = {}
    lo_mnt = traffic["lo"]["max_new_tokens"]
    hi_mnt = traffic["hi"]["max_new_tokens"]
    t0 = clock()
    front = FrontDoor(server, make_request_fn=_request_fn(prompts, t0))
    sent = 0

    def send_lo(t_due: float) -> int:
        nonlocal sent
        rid = LO_BASE + sent
        prompts[rid] = work.lo_prompt(sent)
        front.arrive(ArrivalSpec(t=t_due, rid=rid, crit=Crit.LO,
                                 priority=rid, max_new_tokens=lo_mnt))
        sent += 1
        return rid

    def done(rid) -> bool:
        r = server.requests.get(rid)
        return r is not None and r.done

    steps: List[tuple] = []
    nxt = work.release(0)
    clients = [send_lo(0.0) for _ in range(traffic["lo"]["clients"])]
    hi_rids = [rel.k for rel in work.hi]
    length = min(SLICE_S, 0.2 * seconds)
    slice_at, slice_end = max(0.0, seconds - length - 1.0), 0.0
    clean_s = seconds
    prof_state = 0
    while True:
        now = clock() - t0
        while nxt.t <= now:
            prompts[nxt.k] = nxt.prompt
            front.arrive(ArrivalSpec(t=nxt.t, rid=nxt.k, crit=Crit.HI,
                                     priority=nxt.k, max_new_tokens=hi_mnt))
            nxt = work.release(nxt.k + 1)
        if profiler is not None:
            if prof_state == 0 and now >= slice_at:
                clean_s = now
                profiler.start()
                slice_end = clock() - t0 + length
                prof_state = 1
            elif prof_state == 1 and now >= slice_end:
                profiler.stop()
                prof_state = 2
        if now < seconds:
            for i, rid in enumerate(clients):
                if done(rid):
                    clients[i] = send_lo(server.requests[rid].finished_at
                                         - t0)
        else:
            # checked between steps, so no LO document starts after the
            # close unless its prefill began before it
            open_lo = [r.rid for r in server.requests.values()
                       if r.crit == Crit.LO and r.started_at is not None
                       and not r.done]
            if (all(done(k) for k in hi_rids) and not open_lo) \
                    or now > seconds + GRACE_S:
                break
        front.pump()
        if front.live():
            ta = clock()
            rid = server.step()
            steps.append((ta - t0, clock() - ta, rid))
        else:
            time.sleep(max(0.0, min(nxt.t - now, 0.05)))
    if prof_state == 1:
        profiler.stop()
    front.check_conservation()
    return t0, sent, hi_rids, steps, clean_s


def _request_rows(server, t0: float) -> List[dict]:
    def rel(t):
        return None if t is None else t - t0
    return [dict(rid=r.rid, crit=r.crit.value, prompt_len=len(r.prompt),
                 due=rel(r.submitted_at), started=rel(r.started_at),
                 first_token=rel(r.first_token_at),
                 finished=rel(r.finished_at), done=r.done, saves=r.saves,
                 preemptions=r.preemptions, generated=len(r.generated))
            for r in server.requests.values()]


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, clock: Callable[[], float] = time.monotonic,
             control: bool = False):
    """Set-up, window, check.  Returns (Run, the check's numbers,
    attempted, failed, memory peak); ``control`` adds the fp8 control's
    reading on the same sample (``check.compare``)."""
    from repro_torch.core.scheduler import Policy
    from repro_torch.core.serving import MESCServer
    conf, traffic = cell.config, cell.traffic
    device = torch.device(device)
    on_card = device.type == "cuda"
    cfg = arch_config(conf["program"])
    rc = runtime_config(conf["serve"])
    params = weights.make_params(conf["params"], seed, device)
    work = generator.Workload(traffic, seed, seconds, conf["vocab_size"])
    rec = Recorder(cfg, rc, traffic["max_len"], traced and on_card, clock)
    server = MESCServer(cfg, params, policy=Policy.mesc(), rc=rc,
                        max_len=traffic["max_len"],
                        resident_slots=traffic["resident_slots"],
                        jit_fns=(rec.decode, rec.prefill), clock=clock)
    rec.server = server
    profiler = Profiler() if traced and on_card else None
    with rec.installed():
        _warm_up(server, work, traffic)
        rec.spans.clear()
        if on_card:
            torch.cuda.synchronize()
        setup_s = clock() - t_start
        t0, sent, hi_rids, steps, clean_s = serve_window(
            server, work, traffic, clock, profiler)
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    run = Run(conf=conf, traffic=traffic, seconds=seconds, setup_s=setup_s,
              device_kind=kind, requests=_request_rows(server, t0),
              steps=steps, clean_s=clean_s)
    for s in rec.spans:
        s["t0"] -= t0
        s["t1"] -= t0
    run.spans = rec.spans
    if profiler is not None and profiler.t1:
        run.trace = profiler.reduce()
    finished = [dict(crit=r.crit.value, prompt=r.prompt,
                     generated=list(r.generated), saves=r.saves)
                for r in server.requests.values() if r.done]
    hi_set = set(hi_rids)
    failed = sum(1 for r in run.requests
                 if r["rid"] in hi_set and not r["done"])
    attempted = len(hi_rids) + sent
    # the program's state goes before the reference runs; the weights are
    # the benchmark's own inputs and stay
    for r in server.requests.values():
        r.cache = None
    del server, rec
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    reqs = check.sample(finished, conf["check"], seed)
    t_check = time.monotonic()
    numbers = check.compare(conf, params, reqs, control=control)
    numbers["check_s"] = time.monotonic() - t_check
    numbers["lo_docs"] = sum(1 for r in reqs if r["crit"] == "LO")
    numbers["hi_requests"] = sum(1 for r in reqs if r["crit"] == "HI")
    numbers["saved_docs"] = sum(1 for r in reqs if r["saves"] > 0)
    return run, numbers, attempted, failed, peak
