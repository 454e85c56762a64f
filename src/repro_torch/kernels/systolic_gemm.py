"""Checkpointable GEMM — twin of the reference's ``kernels/systolic_gemm.py``.

The paper's accelerator can save its fp32 accumulator in the middle of a
product ("step_wise_mvout") and resume later, which gives preemption
*inside* one GEMM:

    acc = gemm_partial(A, B, acc, k0, k1)   # preempt here, acc -> host
    acc = gemm_partial(A, B, acc, k1, nK)   # resume

On a CUDA tensor both functions launch ``csrc/gemm.cu`` (one kernel:
``systolic_gemm`` seeds its accumulator with zeros and casts on the way
out, ``gemm_partial`` seeds it from ``acc`` and writes it back in fp32).
On a CPU tensor they run the plain version in ``kernels/ref.py``.  The
signatures, asserts, block clamping (``min(b*, dim)``) and output dtypes
are the reference's; ``bm``/``bn`` name the reference's VMEM tile and the
CUDA kernel tiles on its own, while ``bk`` keeps its meaning as the
preemption unit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

DEFAULT_BM = 256
DEFAULT_BN = 256
DEFAULT_BK = 256


def _launch_gemm(a, b, acc_in, out, K: int):
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
    M, N = out.shape
    lib = _build.lib()
    err = lib.repro_gemm(
        _build.dtype_code(a), _build.dtype_code(out), a.data_ptr(),
        b.data_ptr(), acc_in.data_ptr() if acc_in is not None else None,
        out.data_ptr(), M, N, K, a.stride(0), b.stride(0),
        acc_in.stride(0) if acc_in is not None else 0, out.stride(0),
        _build.stream_ptr(a))
    _build.check(err, "repro_gemm")


def systolic_gemm(a, b, *, bm: int = DEFAULT_BM, bn: int = DEFAULT_BN,
                  bk: int = DEFAULT_BK, out_dtype=None):
    """C = A @ B with an fp32 accumulator.  A (M,K), B (K,N)."""
    M, K = a.shape
    K2, N = b.shape
    assert K == K2
    bm, bn, bk = min(bm, M), min(bn, N), min(bk, K)
    assert M % bm == 0 and N % bn == 0 and K % bk == 0
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return ref.gemm_ref(a, b, out_dtype)
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    _launch_gemm(a, b, None, out, K)
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
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    _launch_gemm(a_sl, b_sl, acc, out, (k_end - k_begin) * bk)
    _build.LAUNCHES["gemm_partial"] += 1
    return out
