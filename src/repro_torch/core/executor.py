"""Gemmini^RT virtual accelerator (paper SS V); own copy of the
reference's ``core/executor.py``.

Models the micro-architecture pieces the context-switch mechanism needs:

  * 4-class config registers + the **config-copy buffer** holding the most
    recent config instruction of each class (SS V.B);
  * scratchpad banks behind the **address remapper** (SS V.C) and the
    accumulator (no allocation restriction, SS V.C end);
  * a reservation station whose queue can be **frozen** (only flush-class
    instructions proceed) and **flushed**;
  * `step_wise_mvin/mvout` over the default configuration channel, moving
    computation data without touching the live configuration (SS V.A);
  * context save / restore cycle costs derived from the actual resident
    bytes — the quantities the scheduler charges as Upsilon^S/ Upsilon^R.

Cycle accounting is exact w.r.t. the ISA cost model; an optional numpy
backend executes tile GEMMs for the end-to-end demos and tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.isa import (ACCUM_BYTES, CONFIG_CYCLES,
                                  DMA_BYTES_PER_CYCLE, DMA_SETUP_CYCLES,
                                  FLUSH_CYCLES, FREEZE_CYCLES,
                                  REMAP_BLOCK_BYTES, CONFIG_OPS,
                                  Instruction, Op)
from repro_torch.core.remapper import AddressRemapper


@dataclasses.dataclass
class ConfigState:
    ld: Optional[tuple] = None
    st: Optional[tuple] = None
    ex: Optional[tuple] = None
    norm: Optional[tuple] = None

    def as_tuple(self):
        return (self.ld, self.st, self.ex, self.norm)


class ConfigCopyBuffer:
    """Most recent configuration instruction of each of the 4 classes."""

    def __init__(self):
        self.slots: Dict[Op, Optional[tuple]] = {op: None for op in CONFIG_OPS}

    def record(self, ins: Instruction):
        self.slots[ins.op] = (ins.op, ins.meta)

    def snapshot(self) -> tuple:
        return tuple(self.slots[op] for op in CONFIG_OPS)

    def load(self, snap: tuple):
        for op, val in zip(CONFIG_OPS, snap):
            self.slots[op] = val

    def clear(self):
        for op in CONFIG_OPS:
            self.slots[op] = None


@dataclasses.dataclass
class CSBreakdown:
    """Cycle breakdown of one context save or restore."""
    drain: int = 0
    freeze_flush: int = 0
    accumulator: int = 0
    config_buffer: int = 0
    remap_block: int = 0
    scratchpad: int = 0
    reconfig: int = 0
    resend: int = 0

    @property
    def total(self) -> int:
        return (self.drain + self.freeze_flush + self.accumulator
                + self.config_buffer + self.remap_block + self.scratchpad
                + self.reconfig + self.resend)


def _dma_cycles(nbytes: int) -> int:
    if nbytes <= 0:
        return 0
    return DMA_SETUP_CYCLES + -(-nbytes // DMA_BYTES_PER_CYCLE)


class GemminiRT:
    """Cycle-accounting virtual accelerator with RT context switching."""

    def __init__(self, n_banks: int = 8, use_remapper: bool = True):
        self.remapper = AddressRemapper(n_banks=n_banks)
        self.config = ConfigState()
        self.config_buffer = ConfigCopyBuffer()
        self.use_remapper = use_remapper
        self.frozen = False
        self.accum_bytes_used: Dict[int, int] = {}   # per task
        self.spad_bytes: Dict[int, int] = {}         # residency w/o remapper
        self.queue_depth = 8                         # reservation station
        # DRAM context store: tid -> dict of saved regions
        self.dram: Dict[int, dict] = {}
        # per-task eta-bank cache (a task's program never changes mid-run)
        self._eta_banks: Dict[int, int] = {}
        self._bb = self.remapper.bank_bytes
        self._cap = self._bb * len(self.remapper.banks)

    # ------------------------------------------------------------------
    # streaming-mode bookkeeping (the scheduler charges cycles; we track
    # the state the context switch must preserve)
    # ------------------------------------------------------------------

    def note_execution(self, tid: int, cycles: float, program) -> None:
        """Approximate residency growth while a task streams instructions:
        its working set (bounded by eta banks) and accumulator fill.  When
        the scratchpad is contended, residency saturates at what the
        remapper can actually lock (no eviction of other tasks' banks)."""
        bb = self._bb
        cap = self._cap
        eta_banks = self._eta_banks.get(tid)
        if eta_banks is None:
            eta_banks = max(1, -(-min(program.working_set_bytes, cap) // bb))
            self._eta_banks[tid] = eta_banks
        if self.use_remapper:
            rm = self.remapper
            have = rm.resident_bytes(tid)
            avail = have + rm.free_banks() * bb
            want = min(eta_banks * bb, avail,
                       have + int(cycles * DMA_BYTES_PER_CYCLE))
            if want > have:
                rm.write(tid, have, want - have)
        else:
            # no bank model: explicit addressing, residency tracked only in
            # aggregate; every context switch must evacuate it all
            have = self.spad_bytes.get(tid, 0)
            others = sum(v for k, v in self.spad_bytes.items() if k != tid)
            want = min(eta_banks * bb, max(cap - others, 0),
                       have + int(cycles * DMA_BYTES_PER_CYCLE))
            self.spad_bytes[tid] = max(have, want)
        acc = self.accum_bytes_used.get(tid, 0)
        if acc < ACCUM_BYTES:
            self.accum_bytes_used[tid] = min(
                ACCUM_BYTES, acc + int(cycles * DMA_BYTES_PER_CYCLE // 4))

    # ------------------------------------------------------------------
    # Context switch (paper Alg. 1 + SS IV 'Context switch')
    # ------------------------------------------------------------------

    def instruction_freeze(self) -> int:
        self.frozen = True
        return FREEZE_CYCLES

    def flush(self) -> int:
        self.frozen = False
        return FLUSH_CYCLES

    def context_save(self, tcb, drain_cycles: int,
                     next_eta: Optional[int] = None) -> CSBreakdown:
        """Alg. 1 Context_save.  ``drain_cycles`` = remaining cycles of the
        in-flight instruction (instruction-level preemption bound)."""
        tid = tcb.tid
        br = CSBreakdown(drain=int(drain_cycles),
                         freeze_flush=FREEZE_CYCLES + FLUSH_CYCLES)
        # accumulator is always evacuated (step_wise_mvout, default channel)
        acc = self.accum_bytes_used.get(tid, 0)
        br.accumulator = _dma_cycles(acc)
        # config-copy buffer -> DRAM
        br.config_buffer = DMA_SETUP_CYCLES + 4 * CONFIG_CYCLES
        # remapping block -> DRAM
        br.remap_block = _dma_cycles(REMAP_BLOCK_BYTES) if self.use_remapper \
            else 0
        # scratchpad: only if the NEXT task does not fit alongside (line 35)
        if self.use_remapper:
            resident = self.remapper.resident_bytes(tid)
            need_spad = True
            if next_eta is not None:
                need_spad = not self.remapper.fits(next_eta, exclude_tid=None)
        else:
            resident = self.spad_bytes.get(tid, 0)
            need_spad = True    # explicit addressing: always evacuate
        if need_spad and resident > 0:
            br.scratchpad = _dma_cycles(resident)
            saved_spad = resident
            self.remapper.release(tid)
            self.spad_bytes.pop(tid, None)
            kept = False
        else:
            saved_spad = 0
            kept = True
        self.dram[tid] = {
            "accumulator": acc,
            "scratchpad": saved_spad,
            "kept_resident": kept,
            "config": self.config_buffer.snapshot(),
            "remap": self.remapper.snapshot(tid),
        }
        self.accum_bytes_used[tid] = 0
        tcb.data_in_accel = kept
        tcb.config_snapshot = self.dram[tid]["config"]
        tcb.dram_addresses = {"ctx": tid}
        return br

    def context_restore(self, tcb, n_resend: int = 2) -> CSBreakdown:
        """Alg. 1 Context_restore (mirrors save): reload data, update the
        remapping block, reconfig, re-dispatch unanswered instructions."""
        tid = tcb.tid
        ctx = self.dram.get(tid)
        br = CSBreakdown()
        if ctx is None:
            return br
        br.accumulator = _dma_cycles(ctx["accumulator"])
        self.accum_bytes_used[tid] = ctx["accumulator"]
        if not ctx["kept_resident"] and ctx["scratchpad"] > 0:
            br.scratchpad = _dma_cycles(ctx["scratchpad"])
            br.remap_block = _dma_cycles(REMAP_BLOCK_BYTES) \
                if self.use_remapper else 0
            if self.use_remapper:
                self.remapper.restore(tid, ctx["remap"], ctx["scratchpad"])
            else:
                self.spad_bytes[tid] = ctx["scratchpad"]
        br.config_buffer = DMA_SETUP_CYCLES + 4 * CONFIG_CYCLES
        br.reconfig = 4 * CONFIG_CYCLES
        self.config_buffer.load(ctx["config"])
        br.resend = n_resend * 2   # CPU re-dispatch of unanswered insts
        tcb.data_in_accel = True
        return br

    def evict(self, tid: int) -> int:
        """Flush a finished/terminated task's banks (banklock deactivate)."""
        self.remapper.release(tid)
        self.accum_bytes_used.pop(tid, None)
        self.spad_bytes.pop(tid, None)
        self.dram.pop(tid, None)
        return FLUSH_CYCLES

    # -- instruction-accurate execution (demos/tests) -------------------
    def execute(self, ins: Instruction, tid: int) -> int:
        if self.frozen and ins.op not in (Op.FLUSH,):
            raise RuntimeError("accelerator frozen; only flush may proceed")
        if ins.op in CONFIG_OPS:
            self.config_buffer.record(ins)
            setattr(self.config, ins.op.value.split("_")[1],
                    (ins.op, ins.meta))
        elif ins.op in (Op.MVIN, Op.STEP_WISE_MVIN) and self.use_remapper:
            self.remapper.write(tid, 0, ins.bytes)
        elif ins.op == Op.COMPUTE:
            self.accum_bytes_used[tid] = min(
                ACCUM_BYTES, self.accum_bytes_used.get(tid, 0) + 1024)
        return ins.cost
