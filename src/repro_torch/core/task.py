"""Task criticality (own copy of the reference's ``core/task.py`` ``Crit``).

Only what serving uses; the task control block and the simulator's task
model arrive with the simulator engines.
"""
from __future__ import annotations

import enum


class Crit(enum.Enum):
    LO = "LO"
    HI = "HI"
