"""Checkpointable GEMM — twin of the reference's ``kernels/systolic_gemm.py``.

The paper's accelerator can save its fp32 accumulator in the middle of a
product ("step_wise_mvout") and resume later, which gives preemption
*inside* one GEMM:

    acc = gemm_partial(A, B, acc, k0, k1)   # preempt here, acc -> host
    acc = gemm_partial(A, B, acc, k1, nK)   # resume

On a CUDA tensor both functions launch one kernel, chosen by
:func:`gemm_plan`: bf16 operands go to ``csrc/gemm_wgmma.cu`` (wgmma on
the tensor cores, fed by TMA, or by the same kernel's ``async`` producer
where a base or row stride is not a multiple of 16 bytes), fp32 operands
to ``csrc/gemm.cu`` (FFMA, pipelined by cp.async; fp32 stays off TF32).
``systolic_gemm`` seeds the accumulator with zeros and casts on the way
out, ``gemm_partial`` seeds it from ``acc`` and writes it back in fp32.
On a CPU tensor they run the plain version in ``kernels/ref.py``, on a
meta tensor their shapes (``kernels/meta.py``).  The
signatures, asserts, block clamping (``min(b*, dim)``) and output dtypes
are the reference's; ``bm``/``bn`` name the reference's VMEM tile and the
kernels tile on their own, while ``bk`` keeps its meaning as the
preemption unit: ``gemm_partial`` hands the kernel the K slice
[k_begin*bk, k_end*bk) as views, and the bf16 kernel's TMA descriptors
describe that slice, never the whole matrix.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import _build, meta, ref

DEFAULT_BM = 256
DEFAULT_BN = 256
DEFAULT_BK = 256

N_SM = 132                      # the H100 SXM's SMs
# fp32 (FFMA) block tiles, largest first: gemm.cu instantiates these
FP32_TILES = ((128, 64), (32, 32))
# bf16 (wgmma) block tiles: 128 rows (two consumer warpgroups) x BN;
# gemm_wgmma.cu instantiates these
BF16_BM = 128
BF16_BNS = (128, 192)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class GemmPlan:
    """How one call runs: ``route`` is "tma" or "async" (bf16, the wgmma
    kernel's two producers) or "ffma" (fp32); ``vec`` says whether the
    fp32 kernel copies 16 bytes at a time (False for bf16); ``grid`` is
    (N/bn, M/bm) blocks.  No plan splits K: the preemption unit bk already
    cuts it, and the 128^3 product fills 16 SMs with small tiles."""
    route: str
    bm: int
    bn: int
    vec: bool
    grid: Tuple[int, int]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


def _aligned16(ptr: int, ld: int, itemsize: int) -> bool:
    return ptr % 16 == 0 and (ld * itemsize) % 16 == 0


def gemm_plan(M: int, N: int, K: int, dtype, *, a_ptr: int = 0,
              b_ptr: int = 0, lda: int = None, ldb: int = None,
              n_sm: int = N_SM) -> GemmPlan:
    """The route and tile of C (M, N) = A (M, K) @ B (K, N), where A and B
    are the K slice the kernel multiplies, starting at ``a_ptr`` and
    ``b_ptr`` with row strides ``lda`` and ``ldb`` (elements; default
    contiguous).

    bf16: the "tma" route where both bases and row strides are multiples
    of 16 bytes (what a TMA descriptor needs), else "async"; BN is 128 or
    192, the one with the fewest waves x BN (the time of a wave grows with
    BN), the smaller on a tie: 512 x 5632 takes 192 (120 blocks, one wave)
    over 128 (176 blocks, two waves).
    fp32: 128x64 where that gives at least 3/4 of ``n_sm`` blocks (1024^2:
    128 blocks, one wave), else 32x32 (128^3: 16 blocks); 16-byte copies
    (``vec``) where both rows start 16-byte aligned and K and N are
    multiples of 4."""
    lda = K if lda is None else lda
    ldb = N if ldb is None else ldb
    if dtype == torch.bfloat16:
        tma = _aligned16(a_ptr, lda, 2) and _aligned16(b_ptr, ldb, 2)
        rows = _cdiv(M, BF16_BM)
        bn = min(BF16_BNS, key=lambda bn: (
            _cdiv(rows * _cdiv(N, bn), n_sm) * bn, bn))
        return GemmPlan("tma" if tma else "async", BF16_BM, bn, False,
                        (_cdiv(N, bn), rows))
    if dtype == torch.float32:
        vec = (_aligned16(a_ptr, lda, 4) and _aligned16(b_ptr, ldb, 4)
               and K % 4 == 0 and N % 4 == 0)
        for bm, bn in FP32_TILES:
            if _cdiv(M, bm) * _cdiv(N, bn) * 4 >= 3 * n_sm:
                break
        return GemmPlan("ffma", bm, bn, vec, (_cdiv(N, bn), _cdiv(M, bm)))
    raise TypeError(f"gemm kernel takes float32 or bfloat16, got {dtype}")


def _launch_gemm(a, b, acc_in, out) -> GemmPlan:
    """Launch the plan's kernel on the K slice ``a`` (M, K), ``b`` (K, N);
    returns the plan."""
    for t in (a, b):
        if t.stride(-1) != 1:
            raise ValueError("gemm kernel needs unit inner stride")
    if a.dtype != b.dtype:
        raise TypeError(f"A and B dtypes differ: {a.dtype} vs {b.dtype}")
    if acc_in is not None and (acc_in.dtype != torch.float32
                               or not acc_in.is_contiguous()
                               or acc_in.device != a.device):
        raise ValueError("acc must be a contiguous float32 tensor on "
                         "A's device")
    if b.device != a.device or out.device != a.device:
        raise ValueError("gemm operands on different devices")
    M, K = a.shape
    N = out.shape[1]
    plan = gemm_plan(
        M, N, K, a.dtype, a_ptr=a.data_ptr(), b_ptr=b.data_ptr(),
        lda=a.stride(0), ldb=b.stride(0),
        n_sm=torch.cuda.get_device_properties(a.device).multi_processor_count)
    acc_ptr = acc_in.data_ptr() if acc_in is not None else None
    ldacc = acc_in.stride(0) if acc_in is not None else 0
    lib = _build.lib()
    if plan.route == "ffma":
        err = lib.repro_gemm_f32(
            _build.dtype_code(out), plan.bm, plan.bn, int(plan.vec),
            a.data_ptr(), b.data_ptr(), acc_ptr, out.data_ptr(), M, N, K,
            a.stride(0), b.stride(0), ldacc, out.stride(0),
            _build.stream_ptr(a))
        _build.check(err, "repro_gemm_f32")
    else:
        err = lib.repro_gemm_bf16(
            _build.dtype_code(out), int(plan.route == "tma"), plan.bn,
            a.data_ptr(), b.data_ptr(), acc_ptr, out.data_ptr(), M, N, K,
            a.stride(0), b.stride(0), ldacc, out.stride(0),
            _build.stream_ptr(a))
        _build.check(err, "repro_gemm_bf16")
    _build.GEMM_ROUTES[plan.route] += 1
    return plan


def systolic_gemm(a, b, *, bm: int = DEFAULT_BM, bn: int = DEFAULT_BN,
                  bk: int = DEFAULT_BK, out_dtype=None):
    """C = A @ B with an fp32 accumulator.  A (M,K), B (K,N)."""
    _build.check_no_grad("systolic_gemm", a, b)
    M, K = a.shape
    K2, N = b.shape
    assert K == K2
    bm, bn, bk = min(bm, M), min(bn, N), min(bk, K)
    assert M % bm == 0 and N % bn == 0 and K % bk == 0
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return ref.gemm_ref(a, b, out_dtype)
    if a.device.type == "meta":
        return meta.gemm(a, b, None, out_dtype)
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    _launch_gemm(a, b, None, out)
    _build.LAUNCHES["systolic_gemm"] += 1
    return out


def gemm_partial(a, b, acc, k_begin: int, k_end: int, *,
                 bm: int = DEFAULT_BM, bn: int = DEFAULT_BN,
                 bk: int = DEFAULT_BK):
    """Process K-chunks [k_begin, k_end) of C += A@B, resuming from ``acc``.

    ``acc`` is the fp32 accumulator (M, N) saved at the previous preemption
    point; returns the updated accumulator.  ``k_begin``/``k_end`` are in
    units of bk blocks.  The full product is recovered by chaining calls
    until k_end == K // bk and casting.
    """
    _build.check_no_grad("gemm_partial", a, b, acc)
    M, K = a.shape
    _, N = b.shape
    bm, bn, bk = min(bm, M), min(bn, N), min(bk, K)
    assert K % bk == 0
    nk_total = K // bk
    assert 0 <= k_begin < k_end <= nk_total
    if a.device.type == "cpu":
        return ref.gemm_partial_ref(a, b, acc, k_begin, k_end, bk)
    a_sl = a[:, k_begin * bk: k_end * bk]
    b_sl = b[k_begin * bk: k_end * bk]
    if a.device.type == "meta":
        return meta.gemm(a_sl, b_sl, acc, torch.float32)
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    _launch_gemm(a_sl, b_sl, acc, out)
    _build.LAUNCHES["gemm_partial"] += 1
    return out
