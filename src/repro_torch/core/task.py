"""Task model and Task Control Block (paper SS VI.A); own copy of the
reference's ``core/task.py``.

Each sporadic task tau_i = (P_i, T_i, D_i, C_i^LO, C_i^HI, L_i, eta_i).
The TCB extends it with runtime state: program counter into the
instruction stream, data locations (accelerator banks vs DRAM addresses),
timers and status — exactly the fields the paper's monitor (SS VI.B)
tracks.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional


class Crit(enum.Enum):
    LO = "LO"
    HI = "HI"


class Status(enum.Enum):
    READY = "ready"
    RUNNING = "running"
    PENDING = "pending"        # not released / finished current job
    INTERRUPTED = "interrupted"


@dataclasses.dataclass
class TaskParams:
    tid: int
    priority: int              # smaller = higher priority
    period: float              # T_i (cycles)
    deadline: float            # D_i (cycles)
    c_lo: float                # LO-WCET (cycles)
    c_hi: float                # HI-WCET (cycles)
    crit: Crit
    eta: int                   # scratchpad banks needed at full speed
    uses_accelerator: bool = True
    workload: Optional[str] = None   # program library key


@dataclasses.dataclass
class TCB:
    params: TaskParams
    status: Status = Status.PENDING
    pc: int = 0                          # next instruction index
    job_release: float = 0.0
    job_deadline: float = 0.0
    exec_cycles: float = 0.0             # consumed in current job
    budget_overrun: bool = False         # exceeded C_LO (HI-task)
    data_in_accel: bool = False
    banks_held: List[int] = dataclasses.field(default_factory=list)
    dram_addresses: Dict[str, int] = dataclasses.field(default_factory=dict)
    config_snapshot: Optional[tuple] = None
    remap_snapshot: Optional[dict] = None
    pending_resend: List[int] = dataclasses.field(default_factory=list)
    jobs_released: int = 0
    jobs_done: int = 0
    deadline_misses: int = 0
    released_in_hi: bool = False         # LO job released outside LO-mode
    # paper metrics
    blocked_since: Optional[float] = None
    blocking_cause: Optional[str] = None  # 'pi' | 'ci'

    @property
    def tid(self) -> int:
        return self.params.tid

    def release(self, now: float):
        self.status = Status.READY
        self.pc = 0
        self.exec_cycles = 0.0
        self.budget_overrun = False
        self.job_release = now
        self.job_deadline = now + self.params.deadline
        self.jobs_released += 1

    def remaining_budget(self, hi_mode: bool) -> float:
        c = self.params.c_hi if hi_mode else self.params.c_lo
        return max(c - self.exec_cycles, 0.0)
