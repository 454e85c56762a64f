"""Helpers shared by the metric readers."""
from __future__ import annotations

import math


def p90(values):
    """Nearest-rank 90th percentile (the ceil(0.9 n)-th smallest): with
    102 HI a window, 10 lie beyond it.  None when it is unbounded (an
    unfinished request) or there is no value."""
    xs = sorted(values)
    if not xs:
        return None
    v = xs[max(0, math.ceil(0.9 * len(xs)) - 1)]
    return None if math.isinf(v) else v


def in_window(run, t0: float, t1: float, end=None) -> float:
    """The share of [t0, t1] that lies in [0, end) (default: the
    window)."""
    end = run.seconds if end is None else end
    if t1 <= t0:
        return 1.0 if 0.0 <= t0 < end else 0.0
    return max(0.0, min(t1, end) - max(t0, 0.0)) / (t1 - t0)


def hi_due(run, end=None):
    """The HI requests due in [0, end) (default: the window)."""
    end = run.seconds if end is None else end
    return [r for r in run.requests
            if r["crit"] == "HI" and 0.0 <= r["due"] < end]


def clean_spans(run, kind: str, crit=None):
    """The spans of ``kind`` (and ``crit``) that lie in the window before
    a traced run's profiled slice."""
    return [s for s in run.spans if s["kind"] == kind
            and (crit is None or s.get("crit") == crit)
            and s["t0"] >= 0.0 and s["t1"] <= run.clean_s]
