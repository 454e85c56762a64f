"""The GEMM's plan (``kernels/systolic_gemm.py::gemm_plan``), on the CPU:
which kernel and route each call takes, its tile and grid, and that a
product blocked as the kernels block it (the plan's tiles, K in steps,
zero fill outside the K slice) gives the reference's ``gemm_partial``.

The CUDA kernels themselves are held against the plain version on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels.systolic_gemm import (BF16_BNS, FP32_TILES,
                                               gemm_partial, gemm_plan)

BF = torch.bfloat16
F32 = torch.float32
N_SM = 132
BASE = 1 << 20          # a 16-byte-aligned base address


def _slice_plan(M, N, K, k0, k1, bk, dtype, base=BASE):
    """The plan of gemm_partial's call over K blocks [k0, k1) of bk on
    contiguous (M, K) and (K, N) operands at ``base``."""
    size = 2 if dtype == BF else 4
    return gemm_plan(M, N, (k1 - k0) * bk, dtype,
                     a_ptr=base + k0 * bk * size,
                     b_ptr=base + k0 * bk * N * size, lda=K, ldb=N)


@pytest.mark.parametrize("what,plan", [
    # TinyLlama width, the full W1 product (timed) and both calls of the
    # split-3/8 chain with bk 256 (phase 2; the resume call is timed)
    ("w1", lambda: gemm_plan(512, 5632, 2048, BF)),
    ("chain 0-3", lambda: _slice_plan(512, 5632, 2048, 0, 3, 256, BF)),
    ("chain 3-8", lambda: _slice_plan(512, 5632, 2048, 3, 8, 256, BF)),
    ("sweep", lambda: gemm_plan(128, 256, 1024, BF)),
    ("ragged", lambda: gemm_plan(192, 136, 320, BF)),
])
def test_main_path_and_timed_bf16_shapes_take_the_tma_route(what, plan):
    p = plan()
    assert p.route == "tma", what
    assert p.bm == 128 and p.bn in BF16_BNS


def test_tinyllama_width_fills_the_card_in_one_wave():
    """512 x 5632: BN 192 gives 120 blocks, one wave on 132 SMs; 128 would
    give 176 (two waves)."""
    p = gemm_plan(512, 5632, 2048, BF, n_sm=N_SM)
    assert (p.bn, p.grid, p.blocks) == (192, (30, 4), 120)


@pytest.mark.parametrize("what,plan", [
    # a 200-byte row of A (K 100), the card test's ragged shape
    ("K 100", lambda: gemm_plan(200, 72, 100, BF)),
    # a slice that starts 200 bytes into a row (bk 100)
    ("slice at 100", lambda: _slice_plan(200, 72, 400, 1, 3, 100, BF)),
    ("odd base", lambda: gemm_plan(128, 128, 128, BF, a_ptr=BASE + 2)),
    ("B stride", lambda: gemm_plan(128, 100, 128, BF)),
])
def test_operands_tma_cannot_take_go_to_the_async_route(what, plan):
    assert plan().route == "async", what


def test_fp32_resume_call_fills_the_card():
    """The preemptible GEMM's resume call: 1024^2, K blocks [3, 8) of 128:
    128x64 tiles, 128 blocks, one wave (128x128 would leave half the card
    idle)."""
    p = _slice_plan(1024, 1024, 1024, 3, 8, 128, F32)
    assert p.route == "ffma" and p.vec
    assert (p.bm, p.bn) == (128, 64) and p.blocks >= 128


def test_fp32_hi_product_uses_more_than_four_blocks():
    p = gemm_plan(128, 128, 128, F32, n_sm=N_SM)
    assert p.route == "ffma" and p.blocks > 4
    assert (p.bm, p.bn, p.blocks) == (32, 32, 16)


@pytest.mark.parametrize("M,N,K,lda,base,vec", [
    (128, 128, 128, 128, BASE, True),
    (192, 136, 100, 200, BASE + 200, False),   # slice 50 floats in a row
    (130, 70, 33, 33, BASE, False),            # K, N not multiples of 4
    (64, 64, 64, 66, BASE, False),             # a row stride of 264 bytes
])
def test_fp32_copies_16_bytes_only_where_rows_are_aligned(M, N, K, lda, base,
                                                          vec):
    assert gemm_plan(M, N, K, F32, a_ptr=base, b_ptr=BASE, lda=lda).vec is vec


@pytest.mark.parametrize("M,N", [(1, 1), (128, 128), (129, 200), (512, 5632),
                                 (1024, 1024), (4096, 4096)])
@pytest.mark.parametrize("dtype", [F32, BF])
def test_plan_grid_covers_the_output_once(M, N, dtype):
    p = gemm_plan(M, N, 256, dtype)
    assert p.grid == (-(-N // p.bn), -(-M // p.bm))
    assert (p.bm, p.bn) in FP32_TILES if dtype == F32 else p.bm == 128
    # no smaller grid covers it: each last tile row / column is non-empty
    assert (p.grid[0] - 1) * p.bn < N and (p.grid[1] - 1) * p.bm < M


def test_plan_refuses_other_dtypes():
    with pytest.raises(TypeError):
        gemm_plan(64, 64, 64, torch.float16)


def _blocked_partial(a, b, acc, k0, k1, bk, plan, step):
    """acc + A[:, slice] @ B[slice, :] computed as the kernels do: over the
    plan's output tiles, K in steps of ``step`` within the slice, reads
    past the slice's or the operands' edges filled with zeros."""
    lo, hi = k0 * bk, k1 * bk
    a_sl, b_sl = a[:, lo:hi], b[lo:hi]
    M, N = acc.shape
    K = hi - lo
    out = np.empty_like(acc)
    for bi in range(plan.grid[1]):
        for bj in range(plan.grid[0]):
            r = slice(bi * plan.bm, min((bi + 1) * plan.bm, M))
            c = slice(bj * plan.bn, min((bj + 1) * plan.bn, N))
            tile = acc[r, c].copy()                       # the seed
            for kt in range(-(-K // step)):
                at = np.zeros((r.stop - r.start, step), np.float32)
                bt = np.zeros((step, c.stop - c.start), np.float32)
                ks = slice(kt * step, min((kt + 1) * step, K))
                at[:, :ks.stop - ks.start] = a_sl[r, ks]
                bt[:ks.stop - ks.start] = b_sl[ks, c]
                tile += at @ bt
            out[r, c] = tile
    return out


@pytest.mark.parametrize("dtype,step", [(F32, 32), (BF, 64)])
@pytest.mark.parametrize("M,N,bk,nk,k0,k1", [
    (200, 72, 100, 4, 1, 3), (192, 136, 50, 4, 0, 3), (64, 300, 40, 3, 2, 3)])
def test_blocked_product_of_the_plan_matches_the_reference(
        dtype, step, M, N, bk, nk, k0, k1):
    """NaN outside the K slice stays outside: the blocked product over the
    plan's tiles, seeded with a random accumulator, equals the reference's
    gemm_partial on the clean operands."""
    rng = np.random.default_rng([3, M, N, bk])
    a = rng.standard_normal((M, nk * bk)).astype(np.float32)
    b = rng.standard_normal((nk * bk, N)).astype(np.float32)
    acc = rng.standard_normal((M, N)).astype(np.float32)
    if dtype == BF:                      # bf16 operands, exact in fp32
        a = torch.from_numpy(a).to(BF).float().numpy()
        b = torch.from_numpy(b).to(BF).float().numpy()
    want = np.asarray(jref.gemm_partial_ref(jnp.asarray(a), jnp.asarray(b),
                                            jnp.asarray(acc), k0, k1, bk))
    ap, bp = a.copy(), b.copy()
    ap[:, :k0 * bk] = np.nan
    ap[:, k1 * bk:] = np.nan
    bp[:k0 * bk] = np.nan
    bp[k1 * bk:] = np.nan
    plan = _slice_plan(M, N, nk * bk, k0, k1, bk, dtype)
    got = _blocked_partial(ap, bp, acc, k0, k1, bk, plan, step)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_cpu_call_counts_no_route():
    """On the CPU the wrapper runs the plain version and launches nothing."""
    _build.reset_launches()
    a = torch.ones(64, 64)
    gemm_partial(a, a, torch.zeros(64, 64), 0, 1, bk=64)
    assert _build.GEMM_ROUTES == {"tma": 0, "async": 0, "ffma": 0}
