"""MESC task scheduler: Alg. 1 (Context_switch / save / restore) and the
mode-switch rules of SS IV (own copy of the reference's
``core/scheduler.py``).

  * LO-mode:   highest priority ready task runs (HI and LO alike); bank
               allocation keeps every task at its minimal eta.
  * Transition: HI-tasks first; LO-tasks may run only if their computation
               data is still resident (not yet saved back), until at most
               one LO-task has data in the accelerator -> HI-mode.
  * HI-mode:   HI-tasks first; LO-tasks run only when no HI-task is active
               (imprecise-MCS stance: LO is never dropped).  A LO-task
               preempting another LO-task forces full eviction of the
               previous LO data (<=1 resident LO-task invariant).
  * Idle system -> revert to LO-mode.

Preemption granularity is a policy knob: 'instruction' (Gemmini^RT),
'operator' (limited preemption), 'none' (conventional NPU).  AMC baseline:
``drop_lo_in_hi`` cancels LO jobs in HI-mode (paper Fig. 8 comparison).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional

from repro_torch.core.task import Crit, Status, TCB


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


ACTIVE = (Status.READY, Status.INTERRUPTED, Status.RUNNING)


def eligible_set(tcbs: Dict[int, TCB], mode: Mode, resident: List[int],
                 policy: Policy) -> List[TCB]:
    """Tasks schedulable under the current mode rules (SS IV)."""
    active = [t for t in tcbs.values() if t.status in ACTIVE]
    hi_active = any(t.params.crit == Crit.HI for t in active)
    out = []
    for t in active:
        if t.params.crit == Crit.HI or mode == Mode.LO:
            out.append(t)
            continue
        if policy.drop_lo_in_hi:          # AMC: LO dropped outside LO-mode
            continue
        if hi_active:                     # LO only when no HI-task is active
            continue
        if mode == Mode.TRANS and not (t.data_in_accel
                                       or t.tid in resident):
            continue                      # only not-yet-saved LO may run
        out.append(t)
    return out


def pick_next(tcbs: Dict[int, TCB], mode: Mode, resident: List[int],
              policy: Policy) -> Optional[TCB]:
    """Kernel.Scheduler.Find_next_task with MESC mode rules.

    Single fused pass over the TCBs (the simulator calls this once per
    scheduling event); equivalent to
    ``min(eligible_set(...), key=priority)`` with first-wins ties.
    """
    # ACTIVE == every status but PENDING, so one identity check suffices
    active = [t for t in tcbs.values() if t.status is not Status.PENDING]
    mode_lo = mode is Mode.LO
    hi_active = False
    if not mode_lo:
        for t in active:
            if t.params.crit is Crit.HI:
                hi_active = True
                break
    drop_lo = policy.drop_lo_in_hi
    trans = mode is Mode.TRANS
    best: Optional[TCB] = None
    best_prio = None
    for t in active:
        if t.params.crit is not Crit.HI and not mode_lo:
            if drop_lo or hi_active:
                continue
            if trans and not (t.data_in_accel or t.tid in resident):
                continue
        prio = t.params.priority
        if best is None or prio < best_prio:
            best = t
            best_prio = prio
    return best


def update_mode(mode: Mode, tcbs: Dict[int, TCB], resident_lo: List[int],
                any_active: bool) -> Mode:
    """Transition/HI/LO mode progression (SS IV 'Mode switch')."""
    if mode == Mode.TRANS and len(resident_lo) <= 1:
        return Mode.HI
    if mode != Mode.LO and not any_active:
        return Mode.LO            # system idle -> revert
    return mode


# ----------------------------------------------------------------------
# Multi-accelerator coordination (platform layer, see docs/scheduling.md)
# ----------------------------------------------------------------------

MODE_SEVERITY = {Mode.LO: 0, Mode.TRANS: 1, Mode.HI: 2}


class ModeCoordinator:
    """Per-instance mode machines + the platform-wide aggregate.

    Partitioned MESC runs one SS IV mode machine *per accelerator
    instance*: an overrun on instance ``i`` degrades only ``i``'s mode
    (its LO-tasks yield, its resident-LO countdown runs), while other
    instances keep serving their partitions in LO-mode.  The
    coordinator tracks every instance's mode and exposes the platform
    mode — the most severe per-instance mode — which gates global
    decisions: LO-task migration targets must be in LO-mode, and
    platform-level telemetry (mode residency, degraded-instance count)
    reads from here.
    """

    def __init__(self, n_instances: int):
        self.modes: List[Mode] = [Mode.LO] * n_instances

    def set_mode(self, inst: int, mode: Mode) -> None:
        self.modes[inst] = mode

    def mode_of(self, inst: int) -> Mode:
        return self.modes[inst]

    def update_instance(self, inst: int, tcbs: Dict[int, TCB],
                        resident_lo: List[int], any_active: bool) -> Mode:
        """Run one instance's SS IV progression and record the result."""
        self.modes[inst] = update_mode(self.modes[inst], tcbs,
                                       resident_lo, any_active)
        return self.modes[inst]

    def platform_mode(self) -> Mode:
        """Most severe mode across instances (LO < transition < HI)."""
        return max(self.modes, key=MODE_SEVERITY.__getitem__)

    def instances_in(self, mode: Mode) -> List[int]:
        return [i for i, m in enumerate(self.modes) if m == mode]

    def degraded(self) -> List[int]:
        """Instances that have left LO-mode."""
        return [i for i, m in enumerate(self.modes) if m != Mode.LO]
