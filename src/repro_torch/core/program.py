"""Workload -> instruction-stream compiler + cycle cost model (the
SS V.A instruction streams the SS VIII workloads execute); own copy of
the reference's ``core/program.py``.

A :class:`Program` is a sequence of :class:`Segment`s; each segment is a
repeating instruction pattern (the tiled-GEMM inner loop), so cycle
prefix-sums and instruction boundaries are O(1) analytic queries — the
discrete-event simulator preempts mid-stream without materializing millions
of Instruction objects.  ``instructions()`` still yields the full stream for
the real executor and Fig. 2(c) histograms.

The workload library covers the paper's benchmarks (AlexNet, MobileNet,
ResNet-50, Transformer — conv layers as im2col GEMMs) plus layer GEMMs of
the assigned architectures (reduced widths), tying the MCS half of the
system to the model half.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.isa import (DMA_SETUP_CYCLES, DMA_BYTES_PER_CYCLE, TILE_DIM,
                            CONFIG_CYCLES, Instruction, Op, instruction_cost)


@dataclasses.dataclass(frozen=True)
class Segment:
    """``repeats`` x ``pattern`` instructions, all in one operator."""
    pattern_ops: Tuple[Op, ...]
    pattern_costs: Tuple[int, ...]
    repeats: int
    operator: int

    @property
    def pattern_cycles(self) -> int:
        return sum(self.pattern_costs)

    @property
    def cycles(self) -> int:
        return self.pattern_cycles * self.repeats

    @property
    def n_instructions(self) -> int:
        return len(self.pattern_costs) * self.repeats


@dataclasses.dataclass
class Program:
    name: str
    segments: List[Segment]
    working_set_bytes: int        # peak input/weight tile residency

    def __post_init__(self):
        ends = np.cumsum([s.cycles for s in self.segments])
        self._seg_ends = ends
        self._total = int(ends[-1]) if len(ends) else 0
        op_ids = sorted({s.operator for s in self.segments})
        op_end: Dict[int, int] = {}
        for s, e in zip(self.segments, ends):
            op_end[s.operator] = int(e)
        self._operator_ends = np.asarray([op_end[o] for o in op_ids])
        # per-segment scalars precomputed once — Segment.cycles /
        # pattern_cycles are properties that re-sum on every access,
        # which dominates the boundary queries in the simulator hot loop
        self._seg_cycles = [s.cycles for s in self.segments]
        self._seg_pattern_cycles = [s.pattern_cycles for s in self.segments]

    @property
    def total_cycles(self) -> int:
        return self._total

    @property
    def n_instructions(self) -> int:
        return sum(s.n_instructions for s in self.segments)

    @property
    def max_instruction_cycles(self) -> int:
        return max(max(s.pattern_costs) for s in self.segments)

    @property
    def n_operators(self) -> int:
        return len(self._operator_ends)

    def operator_cycle_sizes(self) -> np.ndarray:
        e = self._operator_ends
        return np.diff(np.concatenate([[0], e]))

    def next_instruction_boundary(self, offset: float) -> int:
        """Smallest instruction-end cycle > offset (instruction-level
        preemption point).  O(log #segments).  Offsets beyond the program
        end wrap (overrunning jobs re-stream the workload)."""
        base = 0.0
        if offset >= self._total:
            base = (offset // self._total) * self._total
            offset = offset - base
        offset = min(max(offset, 0.0), self._total - 1e-9)
        i = int(np.searchsorted(self._seg_ends, offset, side="right"))
        seg = self.segments[i]
        seg_start = self._seg_ends[i] - self._seg_cycles[i]
        within = offset - seg_start
        pat = self._seg_pattern_cycles[i]
        rep = int(within // pat)
        rem = within - rep * pat
        acc = 0
        for c in seg.pattern_costs:
            acc += c
            if acc > rem:
                return int(base + seg_start + rep * pat + acc)
        return int(base + seg_start + (rep + 1) * pat)

    def next_operator_boundary(self, offset: float) -> int:
        """Smallest operator-end cycle > offset (limited preemption)."""
        base = 0.0
        if offset >= self._total:
            base = (offset // self._total) * self._total
            offset -= base
        e = self._operator_ends
        i = int(np.searchsorted(e, offset, side="right"))
        return int(base + e[min(i, len(e) - 1)])

    def instruction_cost_histogram(self) -> Dict[Op, np.ndarray]:
        """op -> array of (cost, count) pairs — Fig. 2(c) data."""
        acc: Dict[Op, Dict[int, int]] = {}
        for s in self.segments:
            for op, c in zip(s.pattern_ops, s.pattern_costs):
                acc.setdefault(op, {})
                acc[op][c] = acc[op].get(c, 0) + s.repeats
        return {op: np.array(sorted(d.items())) for op, d in acc.items()}

    def instructions(self, max_n: int = 10_000_000) -> Iterator[Instruction]:
        n = 0
        for s in self.segments:
            last_idx = len(s.pattern_ops) - 1
            for r in range(s.repeats):
                for j, (op, c) in enumerate(zip(s.pattern_ops,
                                                s.pattern_costs)):
                    yield Instruction(op=op, bytes=_bytes_from_cost(op, c),
                                      k=_k_from_cost(op, c),
                                      operator=s.operator,
                                      last_in_operator=(
                                          r == s.repeats - 1 and j == last_idx))
                    n += 1
                    if n >= max_n:
                        return


def _bytes_from_cost(op: Op, cost: int) -> int:
    if op in (Op.MVIN, Op.MVOUT, Op.STEP_WISE_MVIN, Op.STEP_WISE_MVOUT):
        return max(cost - DMA_SETUP_CYCLES, 1) * DMA_BYTES_PER_CYCLE
    return 0


def _k_from_cost(op: Op, cost: int) -> int:
    if op == Op.COMPUTE:
        return max(cost - 2 * TILE_DIM, 1)
    return 0


# ---------------------------------------------------------------------------
# GEMM -> tiled instruction segments
# ---------------------------------------------------------------------------

def gemm_segments(M: int, K: int, N: int, operator: int,
                  dtype_bytes: int = 1) -> List[Segment]:
    """im2col GEMM on the 16x16 systolic array, Gemmini dataflow:
    per output tile: loop_k {mvin A, mvin B, preload, compute}; mvout C."""
    tm, tk, tn = (max(1, -(-d // TILE_DIM)) for d in (M, K, N))
    tile_bytes = TILE_DIM * TILE_DIM * dtype_bytes
    mv = DMA_SETUP_CYCLES + -(-tile_bytes // DMA_BYTES_PER_CYCLE)
    comp = min(K, TILE_DIM) + 2 * TILE_DIM
    inner = Segment(
        pattern_ops=(Op.MVIN, Op.MVIN, Op.PRELOAD, Op.COMPUTE),
        pattern_costs=(mv, mv, TILE_DIM, comp),
        repeats=tm * tn * tk,
        operator=operator)
    out = Segment(
        pattern_ops=(Op.MVOUT,),
        pattern_costs=(DMA_SETUP_CYCLES
                       + -(-TILE_DIM * TILE_DIM * 4 // DMA_BYTES_PER_CYCLE),),
        repeats=tm * tn,
        operator=operator)
    return [inner, out]


def activation_segments(n_elems: int, operator: int) -> List[Segment]:
    """Non-GEMM operator (ReLU/Softmax/pooling): streamed moves."""
    n_tiles = max(1, n_elems // (TILE_DIM * TILE_DIM))
    mv = DMA_SETUP_CYCLES + TILE_DIM * TILE_DIM // DMA_BYTES_PER_CYCLE
    return [Segment(pattern_ops=(Op.MVIN, Op.MVOUT),
                    pattern_costs=(mv, mv), repeats=n_tiles,
                    operator=operator)]


def build_program(name: str, gemms: Sequence[Tuple[int, int, int]],
                  act_after: bool = True) -> Program:
    """One operator per GEMM (+ its activation), config insts up front."""
    segs: List[Segment] = [Segment(
        pattern_ops=(Op.CONFIG_LD, Op.CONFIG_ST, Op.CONFIG_EX, Op.CONFIG_NORM),
        pattern_costs=(CONFIG_CYCLES,) * 4, repeats=1, operator=0)]
    ws = 0
    for i, (M, K, N) in enumerate(gemms):
        segs += gemm_segments(M, K, N, operator=i)
        if act_after:
            segs += activation_segments(M * N, operator=i)
        ws = max(ws, (min(M, 256) * min(K, 1024)
                      + min(K, 1024) * min(N, 256)))
    return Program(name=name, segments=segs, working_set_bytes=ws)


# ---------------------------------------------------------------------------
# Workload library (paper SS III: AlexNet / MobileNet / ResNet-50 /
# Transformer) — conv layers as im2col GEMMs (M = out_h*out_w, K =
# k*k*c_in, N = c_out), batch 1, int8.
# ---------------------------------------------------------------------------

ALEXNET = [(3025, 363, 96), (729, 2400, 256), (169, 2304, 384),
           (169, 3456, 384), (169, 3456, 256), (1, 9216, 4096),
           (1, 4096, 4096), (1, 4096, 1000)]

MOBILENET = ([(12544, 27, 32)] +
             [(12544 // (4 ** (i // 2)), 9 * c, c)
              for i, c in enumerate([32, 64, 128, 128, 256, 256])] +
             [(196, 9 * 512, 512)] * 5 + [(49, 9 * 1024, 1024),
                                          (1, 1024, 1000)])

RESNET50 = ([(12544, 147, 64)] +
            [(3136, 576, 64), (3136, 64, 256)] * 3 +
            [(784, 1152, 128), (784, 128, 512)] * 4 +
            [(196, 2304, 256), (196, 256, 1024)] * 6 +
            [(49, 4608, 512), (49, 512, 2048)] * 3 + [(1, 2048, 1000)])

TRANSFORMER = [(512, 512, 512)] * 4 + [(512, 512, 2048), (512, 2048, 512)] \
    + [(512, 512, 512)] * 4 + [(512, 512, 2048), (512, 2048, 512)]

# small single-operator probes (paper's "small workloads" bucket)
SMALL_GEMM = [(128, 128, 128)]
MEDIUM_GEMM = [(512, 1024, 512)] * 3


def arch_layer_gemms(cfg: ArchConfig, seq: int = 128) -> List[Tuple[int, int, int]]:
    """One block's GEMMs for an assigned architecture (reduced seq)."""
    d, dh = cfg.d_model, cfg.dh
    g = [(seq, d, cfg.n_heads * dh), (seq, d, 2 * cfg.n_kv_heads * dh),
         (seq, cfg.n_heads * dh, d)]
    f = cfg.moe.d_expert if cfg.moe else (cfg.d_ff or d)
    g += [(seq, d, f), (seq, d, f), (seq, f, d)]
    return g


def scaled(gemms, f: float):
    return [(max(1, int(M * f)), max(1, int(K * f)), max(1, int(N * f)))
            for (M, K, N) in gemms]


def workload_library(include_archs: bool = True) -> Dict[str, Program]:
    """Paper workloads + scaled variants spanning the paper's Fig. 2(a)
    buckets: small [0,1M], medium (1M,10M], large (10M,1G] cycles."""
    lib = {
        "small_gemm": build_program("small_gemm", SMALL_GEMM),
        "medium_gemm": build_program("medium_gemm", MEDIUM_GEMM),
        "alexnet": build_program("alexnet", ALEXNET),
        "mobilenet": build_program("mobilenet", MOBILENET),
        "resnet50": build_program("resnet50", RESNET50),
        "transformer": build_program("transformer", TRANSFORMER),
        "alexnet_s": build_program("alexnet_s", scaled(ALEXNET, 0.25)),
        "resnet50_s": build_program("resnet50_s", scaled(RESNET50, 0.25)),
        "transformer_s": build_program("transformer_s",
                                       scaled(TRANSFORMER, 0.33)),
        "mobilenet_s": build_program("mobilenet_s", scaled(MOBILENET, 0.2)),
        "alexnet_xs": build_program("alexnet_xs", scaled(ALEXNET, 0.08)),
        "transformer_xs": build_program("transformer_xs",
                                        scaled(TRANSFORMER, 0.12)),
    }
    if include_archs:
        from repro_torch.configs import ARCHS
        for name, cfg in ARCHS.items():
            lib[f"arch:{name}"] = build_program(
                f"arch:{name}", arch_layer_gemms(cfg, seq=128))
    return lib
