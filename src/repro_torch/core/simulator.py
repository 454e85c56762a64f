"""Run metrics of the MESC simulation (partial own copy of the
reference's ``core/simulator.py``).

Only what the lockstep engine (``core.simulator_jit``) returns is here:
``RunMetrics``, its ``AggSamples`` sum/count aggregates and the demand
profiles every engine understands.  The event engine (``MCSSimulator``,
``simulate``) arrives with the host-engine slice (ROADMAP queue 1 item
6.2).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Union

#: Demand profiles every engine understands.  "sampled" draws each
#: release's demand (counter-based draws in the lockstep engine);
#: "nominal" pins demand at c_lo and consumes zero draws.
#: simulator_vec re-exports it.
DEMAND_PROFILES = ("sampled", "nominal")


class AggSamples:
    """Sum/count aggregate standing in for a per-event sample list.

    The lockstep engine (``core.simulator_jit``) accumulates
    blocking/save/restore statistics on the device as ``(total, n)``
    pairs instead of materializing unbounded per-event lists;
    RunMetrics fields typed ``List[float]`` may hold one of these
    instead.  The totals are accumulated in event order, so on a
    trajectory identical to the host engines' they are bit-identical
    too.
    """
    __slots__ = ("total", "n")

    def __init__(self, total: float, n: int):
        self.total = float(total)
        self.n = int(n)

    def __len__(self) -> int:
        return self.n

    @property
    def mean(self) -> float:
        """Mean of the aggregated samples; NaN for an empty aggregate
        (a run with zero blocking/save/restore events is normal — it
        must not raise ``ZeroDivisionError`` in a metrics pipeline)."""
        if self.n == 0:
            return float("nan")
        return self.total / self.n

    def __eq__(self, other) -> bool:
        return (isinstance(other, AggSamples)
                and self.total == other.total and self.n == other.n)

    def __iter__(self):
        raise TypeError(
            "AggSamples is a sum/count aggregate, not a sample list — "
            "read .total/.n; the lockstep engine does not materialize "
            "per-event samples")

    def __repr__(self) -> str:
        return f"AggSamples(total={self.total!r}, n={self.n})"


# per-event sample lists, or AggSamples when the producing engine
# (core.simulator_jit) carries aggregates instead
Samples = Union[List[float], AggSamples]


@dataclasses.dataclass
class RunMetrics:
    pi_blocking: Samples = dataclasses.field(default_factory=list)
    ci_blocking: Samples = dataclasses.field(default_factory=list)
    save_cycles: Samples = dataclasses.field(default_factory=list)
    restore_cycles: Samples = dataclasses.field(default_factory=list)
    jobs: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"LO": 0, "HI": 0})
    done: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"LO": 0, "HI": 0})
    misses: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"LO": 0, "HI": 0})
    misses_by_mode: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"LO": 0, "transition": 0, "HI": 0})
    lo_released_in_hi: int = 0
    lo_done_in_hi: int = 0
    mode_cycles: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"LO": 0.0, "transition": 0.0, "HI": 0.0})
    cs_count: int = 0
    exec_cycles: float = 0.0
    overhead_cycles: float = 0.0

    def success(self, scope: str = "all") -> bool:
        if scope == "HI":
            return self.misses["HI"] == 0
        return self.misses["HI"] == 0 and self.misses["LO"] == 0

    def survivability(self) -> float:
        if self.lo_released_in_hi == 0:
            return 1.0
        return self.lo_done_in_hi / self.lo_released_in_hi
