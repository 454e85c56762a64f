"""Task monitor (paper SS VI.B): TCB registry + per-task LO-WCET timers
(own copy of the reference's ``core/monitor.py``).

In the discrete-event simulator the timer interrupt is the 'overrun' event;
this module provides the standalone monitor used by the real executor path
(examples/mcs_serve.py) where wall-clock budgets are tracked per task.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from repro_torch.core.task import Crit, Status, TCB, TaskParams


class TaskMonitor:
    def __init__(self, on_overrun: Optional[Callable[[TCB], None]] = None):
        self.tcbs: Dict[int, TCB] = {}
        self.on_overrun = on_overrun
        self._started_at: Dict[int, float] = {}
        self._accumulated: Dict[int, float] = {}

    def register(self, params: TaskParams) -> TCB:
        tcb = TCB(params=params)
        self.tcbs[params.tid] = tcb
        self._accumulated[params.tid] = 0.0
        return tcb

    # --- timers (Monitor.Timer.* in Alg. 1) -------------------------------
    def timer_set(self, tid: int):
        self._accumulated[tid] = 0.0

    def timer_activate(self, tid: int, now: Optional[float] = None):
        # wall-clock fallback is this monitor's documented contract: the
        # real-executor path tracks budgets in wall time; simulator
        # callers always inject `now`
        self._started_at[tid] = now if now is not None else time.monotonic()  # repro-lint: disable=no-wall-clock

    def timer_pause(self, tid: int, now: Optional[float] = None):
        t0 = self._started_at.pop(tid, None)
        if t0 is not None:
            t1 = now if now is not None else time.monotonic()  # repro-lint: disable=no-wall-clock
            self._accumulated[tid] += t1 - t0
            tcb = self.tcbs[tid]
            tcb.exec_cycles = self._accumulated[tid]
            if (tcb.params.crit == Crit.HI
                    and self._accumulated[tid] > tcb.params.c_lo
                    and not tcb.budget_overrun):
                tcb.budget_overrun = True
                if self.on_overrun:
                    self.on_overrun(tcb)

    def timer_is_zero(self, tid: int) -> bool:
        return self._accumulated.get(tid, 0.0) == 0.0

    def elapsed(self, tid: int) -> float:
        return self._accumulated.get(tid, 0.0)

    # --- status ------------------------------------------------------------
    def update_status(self, tid: int, status: Status):
        self.tcbs[tid].status = status
