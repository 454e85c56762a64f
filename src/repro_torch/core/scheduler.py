"""MESC modes and policies (own copy of the parts of the reference's
``core/scheduler.py`` that serving uses).

Preemption granularity is a policy knob: 'instruction' (Gemmini^RT),
'operator' (limited preemption), 'none' (conventional NPU).  AMC
baseline: ``drop_lo_in_hi`` cancels LO jobs in HI-mode.
"""
from __future__ import annotations

import dataclasses
import enum


class Mode(enum.Enum):
    LO = "LO"
    TRANS = "transition"
    HI = "HI"


@dataclasses.dataclass(frozen=True)
class Policy:
    preemption: str = "instruction"      # instruction | operator | none
    use_banks: bool = True               # address remapper / bank model
    drop_lo_in_hi: bool = False          # AMC
    t_sr: int = 5000                     # scheduler period (cycles)
    name: str = "mesc"

    @staticmethod
    def mesc(**kw) -> "Policy":
        return Policy(name="mesc", **kw)

    @staticmethod
    def non_preemptive() -> "Policy":
        return Policy(preemption="none", name="np")

    @staticmethod
    def limited() -> "Policy":
        return Policy(preemption="operator", name="lp")

    @staticmethod
    def amc(preemption: str = "instruction") -> "Policy":
        return Policy(preemption=preemption, drop_lo_in_hi=True,
                      name=f"amc-{preemption}")


MODE_SEVERITY = {Mode.LO: 0, Mode.TRANS: 1, Mode.HI: 2}
