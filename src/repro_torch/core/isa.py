"""Gemmini^RT instruction set (paper SS V.A, Tbl. I + base Gemmini ops);
own copy of the reference's ``core/isa.py``.

The accelerator executes a *stream* of instructions.  Base ops mirror
Gemmini (CONFIG_*, MVIN/MVOUT, PRELOAD, COMPUTE); the RT extensions are the
paper's contribution: freeze, step-wise moves over the *default
configuration channel* (state moves that do not disturb the live config),
config-copy-buffer moves, reconfig, remapping-block moves and flush_x.

Costs are in accelerator cycles (100 MHz reference clock, as the paper's
FPGA).  The cost model mirrors Gemmini's micro-architecture: DMA moves
bounded by bus width (128 bit = 16 B/cycle), 16x16 systolic tile computes
bounded by K (+ pipeline latency), 2-cycle config writes.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class Op(enum.Enum):
    # --- base Gemmini ---
    CONFIG_LD = "config_ld"
    CONFIG_ST = "config_st"
    CONFIG_EX = "config_ex"
    CONFIG_NORM = "config_norm"
    MVIN = "mvin"
    MVOUT = "mvout"
    PRELOAD = "preload"
    COMPUTE = "compute"
    FENCE = "fence"
    # --- Gemmini^RT extensions (Tbl. I) ---
    INSTRUCTION_FREEZE = "instruction_freeze"
    STEP_WISE_MVIN = "step_wise_mvin"
    STEP_WISE_MVOUT = "step_wise_mvout"
    MVIN_CONFIG_BUFFER = "mvin_config_buffer"
    MVOUT_CONFIG_BUFFER = "mvout_config_buffer"
    RECONFIG = "reconfig"
    MVIN_REMAPPING_BLOCK = "mvin_remapping_block"
    MVOUT_REMAPPING_BLOCK = "mvout_remapping_block"
    FLUSH = "flush"          # flush_x: x in operand.meta['what']


CONFIG_OPS = (Op.CONFIG_LD, Op.CONFIG_ST, Op.CONFIG_EX, Op.CONFIG_NORM)
MOVE_OPS = (Op.MVIN, Op.MVOUT, Op.STEP_WISE_MVIN, Op.STEP_WISE_MVOUT)

# hardware constants (paper SS VIII experimental platform)
DMA_BYTES_PER_CYCLE = 16          # 128-bit bus
DMA_SETUP_CYCLES = 20             # request setup / TLB hit
TILE_DIM = 16                     # 16x16 systolic tile (256 PEs)
CONFIG_CYCLES = 2                 # executed in the reservation station
SCRATCHPAD_BANKS = 8
BANK_BYTES = 32 * 1024
ACCUM_BYTES = 64 * 1024
REMAP_BLOCK_BYTES = 4 * 1024
FREEZE_CYCLES = 2
FLUSH_CYCLES = 10


@dataclasses.dataclass(frozen=True)
class Instruction:
    op: Op
    bytes: int = 0                 # data moved (move ops)
    k: int = 0                     # contraction depth (compute ops)
    operator: int = 0              # operator id (algorithm-boundary marker)
    last_in_operator: bool = False
    meta: Optional[Tuple] = None

    @property
    def cost(self) -> int:
        """Execution cycles once issued (the paper's Fig. 2(c) quantity)."""
        return instruction_cost(self)


def instruction_cost(ins: Instruction) -> int:
    if ins.op in CONFIG_OPS or ins.op == Op.RECONFIG:
        return CONFIG_CYCLES if ins.op != Op.RECONFIG else 4 * CONFIG_CYCLES
    if ins.op in MOVE_OPS:
        return DMA_SETUP_CYCLES + -(-ins.bytes // DMA_BYTES_PER_CYCLE)
    if ins.op == Op.MVOUT_CONFIG_BUFFER or ins.op == Op.MVIN_CONFIG_BUFFER:
        return DMA_SETUP_CYCLES + 4  # 4 stored config words
    if ins.op in (Op.MVIN_REMAPPING_BLOCK, Op.MVOUT_REMAPPING_BLOCK):
        return DMA_SETUP_CYCLES + REMAP_BLOCK_BYTES // DMA_BYTES_PER_CYCLE
    if ins.op == Op.PRELOAD:
        return TILE_DIM  # stream a tile into the array
    if ins.op == Op.COMPUTE:
        return max(ins.k, 1) + 2 * TILE_DIM  # systolic fill + drain
    if ins.op == Op.INSTRUCTION_FREEZE:
        return FREEZE_CYCLES
    if ins.op == Op.FLUSH:
        return FLUSH_CYCLES
    if ins.op == Op.FENCE:
        return 1
    raise ValueError(ins.op)
