"""The RG-LRU scan's plan (``kernels/rglru_scan.py::scan_plan``), on the
CPU: the block width, tile, ring and route each call takes, that the
blocks cover every channel once, and that a scan blocked as the kernel
blocks it (channel blocks, tiles of ``steps``, a partial last tile) gives
the plain version bit for bit and the reference's scan.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import _build, ref
from repro_torch.kernels.rglru_scan import (CHANNELS, PLAN_STAGES,
                                            PLAN_STEPS, STAGES, STEPS,
                                            rglru_scan_tpu, scan_plan)

N_SM = 132
SMEM_MAX = 232448       # bytes of shared memory a block can use on an H100
BASE = 1 << 20          # a 16-byte-aligned base address

# the main path (recurrentgemma-2b's 512- and 8-token prefills), the card
# tests' shapes and ragged ones
SHAPES = [(1, 512, 2560), (1, 8, 2560), (2, 1, 2560), (1, 2560, 2560),
          (2, 128, 256), (1, 64, 512), (1, 37, 100), (1, 33, 37),
          (3, 100, 36), (1, 1, 1)]


def test_main_path_prefill_fills_the_card():
    """(1, 512, 2560): 16 channels a block, 160 blocks (one thread per
    channel gave 20 blocks of 128; 32 channels would give 80)."""
    p = scan_plan(1, 512, 2560, n_sm=N_SM)
    assert p.blocks >= N_SM
    assert (p.channels, p.grid, p.route) == (16, (160, 1), "cp16")


@pytest.mark.parametrize("B,S,D", SHAPES)
def test_chain_lanes_never_exceed_the_blocks_channels(B, S, D):
    p = scan_plan(B, S, D)
    assert p.channels in CHANNELS and p.channels <= 32     # one chain warp
    for x in range(p.grid[0]):
        assert 0 < len(p.block_channels(x)) <= p.channels


@pytest.mark.parametrize("B,S,D", SHAPES)
def test_blocks_cover_every_channel_once(B, S, D):
    p = scan_plan(B, S, D)
    covered = [c for x in range(p.grid[0]) for c in p.block_channels(x)]
    assert covered == list(range(D))
    assert p.grid[1] == B


@pytest.mark.parametrize("B,D", [(1, 2560), (2, 2560), (1, 100), (1, 37),
                                 (64, 2560), (1, 1)])
def test_widest_block_that_still_fills_one_wave(B, D):
    """The widest width with at least one wave of blocks, else the
    narrowest (the most blocks)."""
    p = scan_plan(B, 8, D, n_sm=N_SM)
    full = [c for c in CHANNELS if B * -(-D // c) >= N_SM]
    assert p.channels == (max(full) if full else 8)
    assert p.blocks >= N_SM or p.channels == 8


@pytest.mark.parametrize("D", [37, 100 + 2, 2561, 1, 3])
def test_rows_not_16_byte_aligned_take_4_byte_copies(D):
    assert (D * 4) % 16 != 0
    assert scan_plan(1, 16, D, a_ptr=BASE, b_ptr=BASE).route == "cp4"


@pytest.mark.parametrize("a_ptr,b_ptr,route", [
    (BASE, BASE, "cp16"), (BASE + 4, BASE, "cp4"), (BASE, BASE + 8, "cp4"),
    (BASE + 16, BASE + 32, "cp16")])
def test_unaligned_bases_take_4_byte_copies(a_ptr, b_ptr, route):
    assert scan_plan(1, 512, 2560, a_ptr=a_ptr, b_ptr=b_ptr).route == route


@pytest.mark.parametrize("channels,steps,stages",
                         itertools.product(CHANNELS, STEPS, STAGES))
def test_every_instantiation_fits_shared_memory(channels, steps, stages):
    p = dataclasses.replace(scan_plan(1, 512, 2560), channels=channels,
                            steps=steps, stages=stages)
    assert p.stages >= 2 and p.smem_bytes <= SMEM_MAX
    assert p.smem_bytes == stages * 2 * steps * channels * 4


def test_the_plan_takes_one_of_the_instantiations():
    p = scan_plan(1, 512, 2560)
    assert (p.steps, p.stages) == (PLAN_STEPS, PLAN_STAGES)
    assert p.steps in STEPS and p.stages in STAGES and p.stages >= 2


@pytest.mark.parametrize("B,S,D", [(0, 8, 16), (1, 0, 16), (1, 8, 0),
                                   (65536, 8, 16)])
def test_shapes_the_kernel_cannot_take_raise(B, S, D):
    with pytest.raises(ValueError):
        scan_plan(B, S, D)


def _blocked_scan(a, b, h0, plan):
    """The kernel's order of work in torch: each block's channels, tile by
    tile, step by step, h carried across tiles; the last tile partial."""
    B, S, D = a.shape
    y = torch.full_like(a, float("nan"))
    for bi, x in itertools.product(range(plan.grid[1]), range(plan.grid[0])):
        ch = list(plan.block_channels(x))
        h = h0[bi, ch]
        for t0 in range(0, S, plan.steps):
            for t in range(t0, min(t0 + plan.steps, S)):
                h = a[bi, t, ch] * h + b[bi, t, ch]
                y[bi, t, ch] = h
    return y


@pytest.mark.parametrize("B,S,D", [(1, 33, 37), (1, 37, 100), (2, 1, 40),
                                   (3, 100, 36), (1, 130, 64)])
def test_a_scan_blocked_as_planned_equals_the_plain_version(B, S, D):
    """Blocking D and tiling S change no order of rounding: bit-equal to
    the plain version, and within the reference sweep's atol of the
    reference's scan."""
    rng = np.random.default_rng([B, S, D])
    a = rng.uniform(0.4, 0.999, (B, S, D)).astype(np.float32)
    b = rng.standard_normal((B, S, D)).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    ta, tb, th = map(torch.from_numpy, (a, b, h0))
    plan = scan_plan(B, S, D)
    got = _blocked_scan(ta, tb, th, plan)
    assert torch.equal(got, ref.rglru_scan_ref(ta, tb, th))
    want = jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_wrapper_on_the_cpu_runs_the_plain_version_and_keeps_the_asserts():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0.4, 0.999, (1, 48, 64))
                         .astype(np.float32))
    h0 = torch.zeros((1, 64))
    _build.reset_launches()
    out = rglru_scan_tpu(a, a, h0, block_s=16)
    assert torch.equal(out, ref.rglru_scan_ref(a, a, h0))
    assert _build.LAUNCHES["rglru_scan"] == 0
    with pytest.raises(AssertionError):
        rglru_scan_tpu(a, a, h0, block_s=32)          # 48 % 32 != 0
    with pytest.raises(AssertionError):
        rglru_scan_tpu(a, a, h0, block_d=48)          # 64 % 48 != 0
