"""The traced run's device trace: torch.profiler over a slice of the
window, reduced to what the per-layer metrics and the result's
``breakdown`` read.

Only device activity is recorded (kernels, copies, the CUDA runtime
calls): recording every host operation as well slowed the eager serving
loop's host work several times over inside the slice.  Times are the
profiler's nanoseconds; the slice is the span between ``start`` and
``stop`` on ``time.time_ns()``.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List

import torch

HOST_GAP = "host code between CUDA calls"


@dataclass
class Slice:
    window_s: float
    busy_s: float
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)


class Profiler:
    """``start()`` and ``stop()`` between two steps of the serving loop."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        # the first start initialises CUPTI for seconds, and the eager
        # loop's host work stays slower while it is on: so the slice is the
        # window's end and span metrics read what came before it
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.t0 = self.t1 = 0

    def start(self):
        torch.cuda.synchronize()
        self.prof.start()
        self.t0 = time.time_ns()

    def stop(self):
        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.stop()

    def reduce(self) -> Slice:
        return reduce_events(self.prof.profiler.kineto_results.events(),
                             self.t0, self.t1)


def _is_device(e) -> bool:
    return (e.device_type() != torch.autograd.DeviceType.CPU
            and not e.is_user_annotation())


def _merge(intervals):
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events, t0: int, t1: int) -> Slice:
    kernels, runtime = [], []
    for e in events:
        s = e.start_ns()
        en = s + e.duration_ns()
        if en < t0 or s > t1:
            continue
        if _is_device(e):
            kernels.append((max(s, t0), min(en, t1), e.name()))
        elif e.name().startswith("cu"):
            runtime.append((s, en, e.name()))
    kernels.sort()
    busy = _merge([(s, e) for s, e, _ in kernels])
    busy_ns = sum(e - s for s, e in busy)
    by_name: Dict[str, int] = defaultdict(int)
    for s, e, n in kernels:
        by_name[n] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    return Slice(window_s=(t1 - t0) / 1e9, busy_s=busy_ns / 1e9,
                 device_ops=[[n, ns / 1e9] for n, ns in ops],
                 idle_gaps=_idle_by_host(gaps, runtime))


def _idle_by_host(gaps, runtime) -> List[list]:
    """Idle device time by what the host was doing: the CUDA runtime call
    it was in, else ``HOST_GAP``; the 10 largest totals."""
    runtime.sort()
    starts = [r[0] for r in runtime]
    out: Dict[str, int] = defaultdict(int)
    for gs, ge in gaps:
        covered = 0
        i = max(0, bisect.bisect_left(starts, gs) - 1)
        while i < len(runtime) and runtime[i][0] < ge:
            s, e, n = runtime[i]
            ov = min(e, ge) - max(s, gs)
            if ov > 0:
                out[n] += ov
                covered += ov
            i += 1
        out[HOST_GAP] += max(0, (ge - gs) - covered)
    top = sorted(out.items(), key=lambda kv: -kv[1])[:10]
    return [[n, ns / 1e9] for n, ns in top]
