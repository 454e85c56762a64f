"""Open-loop arrival-process generators for the serving front end (twin
of the reference's ``serving/traffic.py``).

Every random quantity is a counter-based splitmix64 draw keyed
``(seed, stream, arrival_index)`` on host numpy.  There is no host RNG
state: the i-th inter-arrival gap of a given ``(seed, stream)`` is a
pure function of its key, so traffic is byte-reproducible,
prefix-stable (``arrival_times(n)`` is a prefix of ``arrival_times(m >
n)``) and the same under every scheduling policy (common random
numbers).  Every draw is bit-equal to the reference's.

  * :class:`Poisson` — exponential gaps via inverse CDF;
  * :class:`HeavyTail` — Lomax (Pareto-II) gaps matched to the same mean
    rate;
  * :class:`Diurnal` — non-homogeneous Poisson with a sinusoidal rate
    envelope, by thinning a homogeneous candidate stream (both the gap
    and the accept draw are counter-keyed);
  * :class:`Trace` — replay of recorded absolute arrival times;
    :func:`save_trace` / :func:`load_trace` round-trip exactly.

:func:`build_workload` turns an arrival realization into request specs
(criticality mix, token budgets — CRN-drawn on their own streams).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.task import Crit

_GOLD = np.uint64(0x9E3779B97F4A7C15)
_U53 = 1.0 / (1 << 53)

TRACE_FORMAT_VERSION = 1


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer; uint64 wrap-around is the mixer's
    arithmetic, so numpy's overflow warning is silenced."""
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def stream_key(stream: Union[str, int]) -> np.uint64:
    """Stable 64-bit key for a named draw stream (sha256 of
    ``repr(stream)``, as the reference hashes it)."""
    h = hashlib.sha256(repr(stream).encode()).digest()
    return np.uint64(int.from_bytes(h[:8], "little"))


def crn_bits(seed: int, stream: Union[str, int],
             index: Union[int, np.ndarray], sub: int = 0) -> np.ndarray:
    """Raw 64-bit counter-based draw keyed ``(seed, stream, index, sub)``.

    ``index`` may be a scalar or an int array; the result depends only
    on the key tuple, never on call order."""
    idx = np.asarray(index, np.uint64)
    with np.errstate(over="ignore"):
        base = _mix64(np.asarray(_mix64(np.uint64(seed) * _GOLD)
                                 ^ stream_key(stream)))
        ctr = (idx << np.uint64(8)) + np.uint64(sub)
        s = base + ctr * _GOLD
    return _mix64(s)


def crn_u01(seed: int, stream: Union[str, int],
            index: Union[int, np.ndarray], sub: int = 0) -> np.ndarray:
    """Uniform [0, 1) doubles from the top 53 bits of :func:`crn_bits`."""
    return (crn_bits(seed, stream, index, sub) >> np.uint64(11)) \
        .astype(np.float64) * _U53


# ----------------------------------------------------------------------
# Arrival processes
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Poisson:
    """Homogeneous Poisson arrivals at ``rate`` req/s (exponential
    inter-arrival gaps via inverse CDF)."""
    rate: float
    kind = "poisson"

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(f"{self.kind}: rate must be > 0, "
                             f"got {self.rate}")

    def inter_arrivals(self, seed: int, stream: Union[str, int],
                       n: int) -> np.ndarray:
        u = crn_u01(seed, stream, np.arange(n))
        return -np.log1p(-u) / self.rate

    def arrival_times(self, seed: int, stream: Union[str, int],
                      n: int) -> np.ndarray:
        return np.cumsum(self.inter_arrivals(seed, stream, n))


@dataclasses.dataclass(frozen=True)
class HeavyTail:
    """Bursty/heavy-tailed arrivals: Lomax (Pareto-II) gaps with the
    same mean ``1/rate`` as the Poisson baseline but a polynomial tail,
    P(gap > t) ~ t^-alpha.  ``alpha`` must exceed 1 for the mean to
    exist."""
    rate: float
    alpha: float = 2.2
    kind = "heavy_tail"

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(f"{self.kind}: rate must be > 0, "
                             f"got {self.rate}")
        if self.alpha <= 1.0:
            raise ValueError(f"{self.kind}: alpha must be > 1 for a "
                             f"finite mean rate, got {self.alpha}")

    def inter_arrivals(self, seed: int, stream: Union[str, int],
                       n: int) -> np.ndarray:
        # Lomax(x_m, alpha) has mean x_m / (alpha - 1); pick x_m so the
        # mean gap is 1/rate, i.e. the offered load matches Poisson(rate)
        x_m = (self.alpha - 1.0) / self.rate
        u = crn_u01(seed, stream, np.arange(n))
        return x_m * (np.power(1.0 - u, -1.0 / self.alpha) - 1.0)

    def arrival_times(self, seed: int, stream: Union[str, int],
                      n: int) -> np.ndarray:
        return np.cumsum(self.inter_arrivals(seed, stream, n))


@dataclasses.dataclass(frozen=True)
class Diurnal:
    """Non-homogeneous Poisson with a sinusoidal rate envelope
    ``lambda(t) = rate * (1 + amplitude * sin(2 pi t / period_s))``.

    Generated by thinning a homogeneous Poisson at the peak rate: the
    candidate gap uses draw ``(seed, stream, i, sub=0)`` and the accept
    test ``(seed, stream, i, sub=1)``, so candidate ``i``'s fate never
    depends on how many arrivals were requested."""
    rate: float
    amplitude: float = 0.8
    period_s: float = 120.0
    kind = "diurnal"

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(f"{self.kind}: rate must be > 0, "
                             f"got {self.rate}")
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError(f"{self.kind}: amplitude must be in "
                             f"[0, 1), got {self.amplitude}")
        if self.period_s <= 0:
            raise ValueError(f"{self.kind}: period_s must be > 0, "
                             f"got {self.period_s}")

    def arrival_times(self, seed: int, stream: Union[str, int],
                      n: int) -> np.ndarray:
        r_max = self.rate * (1.0 + self.amplitude)
        out: List[float] = []
        t = 0.0
        i = 0
        w = 2.0 * math.pi / self.period_s
        while len(out) < n:
            m = max(2 * (n - len(out)), 64)
            idx = np.arange(i, i + m)
            gaps = -np.log1p(-crn_u01(seed, stream, idx, sub=0)) / r_max
            accept = crn_u01(seed, stream, idx, sub=1)
            for g, a in zip(gaps, accept):
                t += float(g)
                lam = self.rate * (1.0 + self.amplitude * math.sin(w * t))
                if a * r_max < lam:
                    out.append(t)
                    if len(out) == n:
                        break
            i += m
        return np.asarray(out, np.float64)

    def inter_arrivals(self, seed: int, stream: Union[str, int],
                       n: int) -> np.ndarray:
        return np.diff(self.arrival_times(seed, stream, n), prepend=0.0)


@dataclasses.dataclass(frozen=True)
class Trace:
    """Replay of recorded absolute arrival times (seconds, ascending).
    The ``(seed, stream)`` key is accepted for interface uniformity and
    ignored."""
    times: Tuple[float, ...]
    kind = "trace"

    def __post_init__(self):
        ts = np.asarray(self.times, np.float64)
        if ts.size and (np.any(np.diff(ts) < 0) or ts[0] < 0):
            raise ValueError("trace times must be >= 0 and ascending")

    def arrival_times(self, seed: int, stream: Union[str, int],
                      n: int) -> np.ndarray:
        if n > len(self.times):
            raise ValueError(f"trace holds {len(self.times)} arrivals, "
                             f"{n} requested")
        return np.asarray(self.times[:n], np.float64)

    def inter_arrivals(self, seed: int, stream: Union[str, int],
                       n: int) -> np.ndarray:
        return np.diff(self.arrival_times(seed, stream, n), prepend=0.0)


PROCESS_KINDS = ("poisson", "heavy_tail", "diurnal", "trace")


def make_process(kind: str, rate: float, *,
                 trace_path: Optional[Union[str, Path]] = None,
                 **kw) -> Union[Poisson, HeavyTail, Diurnal, Trace]:
    """Factory keyed by process name (the ``--arrivals`` CLI axis)."""
    if kind == "poisson":
        return Poisson(rate, **kw)
    if kind == "heavy_tail":
        return HeavyTail(rate, **kw)
    if kind == "diurnal":
        return Diurnal(rate, **kw)
    if kind == "trace":
        if trace_path is None:
            raise ValueError("arrivals='trace' needs trace_path")
        return load_trace(trace_path)
    raise ValueError(f"unknown arrival process {kind!r}; "
                     f"want one of {PROCESS_KINDS}")


def arrival_times(process, seed: int, stream: Union[str, int],
                  n: int) -> np.ndarray:
    """Absolute arrival times (seconds) of the first ``n`` arrivals of
    ``process`` under key ``(seed, stream)``."""
    return process.arrival_times(seed, stream, n)


# ----------------------------------------------------------------------
# Trace recording / replay
# ----------------------------------------------------------------------

def save_trace(times: Sequence[float], path: Union[str, Path]) -> Path:
    """Write absolute arrival times as a versioned JSON trace.  JSON
    floats use Python's shortest-repr encoding, so
    ``load_trace(save_trace(t)) == t`` bit for bit."""
    path = Path(path)
    payload = {"version": TRACE_FORMAT_VERSION,
               "times": [float(t) for t in times]}
    path.write_text(json.dumps(payload))
    return path


def load_trace(path: Union[str, Path]) -> Trace:
    """Read a trace written by :func:`save_trace`."""
    payload = json.loads(Path(path).read_text())
    version = payload.get("version")
    if version != TRACE_FORMAT_VERSION:
        raise ValueError(f"{path}: trace format version {version!r}, "
                         f"this reader wants {TRACE_FORMAT_VERSION}")
    return Trace(times=tuple(payload["times"]))


# ----------------------------------------------------------------------
# Workload synthesis: arrivals -> request specs
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """One request-to-be: arrival time plus the request's shape.

    Lower priority number = more urgent: HI requests are numbered below
    every LO request, so in any lane's eligible order a HI request is
    never behind a LO request."""
    t: float
    rid: int
    crit: Crit
    priority: int
    max_new_tokens: int
    lo_budget_s: float = float("inf")


def _token_budget(seed: int, stream: str, idx: np.ndarray,
                  mean_tokens: int) -> np.ndarray:
    """Per-request decode-token budget: uniform on
    [mean/2, 3*mean/2], CRN-drawn, at least 1."""
    u = crn_u01(seed, stream, idx)
    lo = max(1, mean_tokens // 2)
    return np.maximum(1, (lo + u * mean_tokens).astype(np.int64))


def build_workload(*, seed: int, lo_process, hi_process,
                   n_lo: int, n_hi: int,
                   lo_tokens: int = 64, hi_tokens: int = 8,
                   hi_lo_budget_s: float = float("inf"),
                   lo_lo_budget_s: float = float("inf"),
                   ) -> List[ArrivalSpec]:
    """Merge a LO and a HI arrival stream into one time-sorted workload.

    LO arrivals draw from streams ``("lo_arrivals", "lo_tokens")`` and
    HI from ``("hi_arrivals", "hi_tokens")`` of the same seed; rids are
    assigned in merged time order (HI first on exact ties) and key the
    per-request service-time draws downstream."""
    lo_t = arrival_times(lo_process, seed, "lo_arrivals", n_lo)
    hi_t = arrival_times(hi_process, seed, "hi_arrivals", n_hi)
    lo_n = _token_budget(seed, "lo_tokens", np.arange(n_lo), lo_tokens)
    hi_n = _token_budget(seed, "hi_tokens", np.arange(n_hi), hi_tokens)
    merged = ([(float(t), 0, i) for i, t in enumerate(hi_t)]
              + [(float(t), 1, i) for i, t in enumerate(lo_t)])
    merged.sort()
    out: List[ArrivalSpec] = []
    for rid, (t, is_lo, i) in enumerate(merged):
        if is_lo:
            out.append(ArrivalSpec(
                t=t, rid=rid, crit=Crit.LO,
                priority=1_000_000 + i, max_new_tokens=int(lo_n[i]),
                lo_budget_s=lo_lo_budget_s))
        else:
            out.append(ArrivalSpec(
                t=t, rid=rid, crit=Crit.HI,
                priority=i, max_new_tokens=int(hi_n[i]),
                lo_budget_s=hi_lo_budget_s))
    return out


def workload_stats(workload: Sequence[ArrivalSpec]) -> Dict[str, float]:
    """Shape summary (offered tokens per class, horizon)."""
    lo = [s for s in workload if s.crit == Crit.LO]
    hi = [s for s in workload if s.crit == Crit.HI]
    return {
        "n_lo": len(lo), "n_hi": len(hi),
        "lo_tokens": float(sum(s.max_new_tokens for s in lo)),
        "hi_tokens": float(sum(s.max_new_tokens for s in hi)),
        "horizon_s": max((s.t for s in workload), default=0.0),
    }
