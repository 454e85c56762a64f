"""In-memory spans and counters of the port's serving path, on the
profiler's clock.

    from repro_torch.runtime import trace
    trace.enable()
    ...                                   # serve
    spans, counters = trace.drain()
    trace.disable()

A site is guarded by the module global ``ON``, so that while the tracer
is off (the default) a site costs that one check: no clock read, no
allocation, no CUDA event::

    with trace.span("serve.decode", rid=r.rid) if trace.ON else trace.NULL:
        ...
    if trace.ON:
        trace.count("serve.saves")

A span records its name, its host start and end, the index of the span
that enclosed it (its parent, -1 for none), a request id and small
attributes.  Stamps are ``time.perf_counter_ns()``; ``drain`` reports
them on ``time.time_ns()``'s clock, the Unix-epoch nanoseconds that
``torch.profiler``'s events carry, through one anchor pair taken at
``enable``.  The spans named in ``DEVICE_TIMED`` also record a CUDA event
at each end on the current stream; ``drain`` synchronises the card once
and resolves each pair to ``device_s``.  Nothing on the hot path
synchronises.

The spans are the tracer's own: nothing reads them to decide what runs,
and every timestamp the scheduler uses stays on its injected clock.  The
serving lane is one thread; a span opened on another thread would nest
under whatever is open.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

#: spans that record a CUDA event at each end
DEVICE_TIMED = frozenset({"model.prefill", "model.decode_step",
                          "model.moe_dispatch", "kernel.flash_attention",
                          "serve.save", "serve.restore"})
#: spans kept at most; later ones are counted under ``trace.dropped``
MAX_SPANS = 1 << 20
#: the counters the program's sites keep, reported from 0
COUNTERS = ("serve.saves", "serve.save_bytes", "serve.restores",
            "serve.restore_bytes", "serve.preemptions", "serve.mode_switches",
            "kernel.decode_plan_miss", "kernel.library_build",
            "model.decode_graph_replays", "model.decode_graph_captures",
            "model.decode_cache_adoptions", "model.decode_eager",
            "trace.dropped")

ON = False

_spans: List["_Span"] = []
_stack: List[int] = []
_counters: Dict[str, int] = defaultdict(int)
_offset_ns = 0          # time.time_ns() - time.perf_counter_ns()
_events = False         # record CUDA events around DEVICE_TIMED spans
_kernel_base: Dict[str, int] = {}
_pool: List[torch.cuda.Event] = []     # events already read by drain()


def _event() -> torch.cuda.Event:
    return _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)


#: the context a guarded site enters while the tracer is off
NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "rid", "attrs", "t0", "t1", "parent", "ev")

    def __init__(self, name: str, rid, attrs: dict):
        self.name, self.rid, self.attrs = name, rid, attrs
        self.t0 = self.t1 = 0
        self.parent = -1
        self.ev: Optional[Tuple] = None

    def __enter__(self):
        if len(_spans) >= MAX_SPANS:        # full: counted, not kept
            _counters["trace.dropped"] += 1
            self.parent = -2
            return self
        self.parent = _stack[-1] if _stack else -1
        _stack.append(len(_spans))
        _spans.append(self)
        if _events and self.name in DEVICE_TIMED:
            self.ev = (_event(), _event())
            self.ev[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.parent == -2:
            return False
        self.t1 = time.perf_counter_ns()
        if self.ev is not None:
            self.ev[1].record()
        _stack.pop()
        return False


def span(name: str, rid=None, **attrs):
    """A span named ``name`` around a ``with`` block (``NULL`` when the
    tracer is off).  Its ``rid`` and ``attrs`` may be set inside the
    block."""
    if not ON:
        return NULL
    return _Span(name, rid, attrs)


def count(name: str, n: int = 1) -> None:
    if ON:
        _counters[name] += n


def _anchor_ns() -> int:
    """time.time_ns() - time.perf_counter_ns(), from the tightest of a
    few bracketed reads."""
    best = None
    for _ in range(8):
        a = time.perf_counter_ns()
        e = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, e - (a + b) // 2)
    return best[1]


def _kernel_counts() -> Dict[str, int]:
    """The kernel wrappers' own counters (``kernels/_build.py``), read
    where they live."""
    from repro_torch.kernels import _build
    out = {f"kernel.launch.{k}": v for k, v in _build.LAUNCHES.items()}
    out.update({f"kernel.route.gemm.{k}": v
                for k, v in _build.GEMM_ROUTES.items()})
    out.update({f"kernel.route.flash.{k}": v
                for k, v in _build.FLASH_ROUTES.items()})
    return out


def enable(device_events: Optional[bool] = None) -> None:
    """Start keeping spans and counts.  ``device_events`` (default: a
    card is present) records CUDA events around ``DEVICE_TIMED`` spans."""
    global ON, _offset_ns, _events, _kernel_base
    if ON:
        return
    _events = (torch.cuda.is_available() if device_events is None
               else bool(device_events))
    _offset_ns = _anchor_ns()
    _kernel_base = _kernel_counts()
    ON = True


def disable() -> None:
    global ON
    ON = False


def drain() -> Tuple[List[dict], Dict[str, int]]:
    """The spans kept since ``enable`` (or the last drain), in the order
    they opened, and the counters: the sites' (``COUNTERS`` from 0) and,
    while the tracer is on, the kernel counters' growth since then.
    Each span is a dict: ``name``,
    ``t0_ns`` and ``t1_ns`` (on ``time.time_ns()``'s clock), ``parent``
    (an index into the list, -1 for none), ``rid``, ``attrs`` and
    ``device_s`` (None where no events were recorded).  Call it with no
    span open; it synchronises the card when events were recorded."""
    global _spans, _counters, _kernel_base
    if _stack:
        raise RuntimeError(f"drain() with {len(_stack)} span(s) open")
    if any(s.ev is not None for s in _spans):
        torch.cuda.synchronize()
    out = []
    for s in _spans:
        out.append(dict(name=s.name, t0_ns=s.t0 + _offset_ns,
                        t1_ns=s.t1 + _offset_ns, parent=s.parent,
                        rid=s.rid, attrs=s.attrs,
                        device_s=(None if s.ev is None else
                                  s.ev[0].elapsed_time(s.ev[1]) / 1e3)))
        if s.ev is not None:
            _pool.extend(s.ev)
    counters = {k: 0 for k in COUNTERS} if ON else {}
    counters.update(_counters)
    if ON:
        now = _kernel_counts()
        counters.update({k: v - _kernel_base.get(k, 0)
                         for k, v in now.items()})
        _kernel_base = now
    _spans, _counters = [], defaultdict(int)
    return out, counters


def self_ns(spans: List[dict]) -> List[int]:
    """Each span's self time: its host time less its children's."""
    out = [s["t1_ns"] - s["t0_ns"] for s in spans]
    for s in spans:
        if s["parent"] >= 0:
            out[s["parent"]] -= s["t1_ns"] - s["t0_ns"]
    return out


def summary(spans: List[dict]) -> Dict[str, dict]:
    """Per span name: count, host ms (total and mean), self ms and
    device ms (where timed), in the order the names first opened."""
    rows: Dict[str, dict] = {}
    for s, own in zip(spans, self_ns(spans)):
        r = rows.setdefault(s["name"], dict(count=0, host_ms=0.0,
                                            self_ms=0.0, device_ms=None))
        r["count"] += 1
        r["host_ms"] += (s["t1_ns"] - s["t0_ns"]) / 1e6
        r["self_ms"] += own / 1e6
        if s["device_s"] is not None:
            r["device_ms"] = (r["device_ms"] or 0.0) + s["device_s"] * 1e3
    for r in rows.values():
        r["mean_ms"] = r["host_ms"] / r["count"]
    return rows


def format_summary(spans: List[dict], counters: Dict[str, int]) -> str:
    """``summary`` and the counters as lines of text."""
    lines = ["span  count  host_ms  mean_ms  self_ms  device_ms"]
    for name, r in summary(spans).items():
        dev = "-" if r["device_ms"] is None else f"{r['device_ms']:.3f}"
        lines.append(f"{name}  {r['count']}  {r['host_ms']:.3f}  "
                     f"{r['mean_ms']:.3f}  {r['self_ms']:.3f}  {dev}")
    lines.append("counters: " + ", ".join(
        f"{k} {v}" for k, v in sorted(counters.items())))
    return "\n".join(lines)
