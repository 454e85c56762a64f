"""The bf16 flash kernel's plan (``kernels/flash_attention.py::
flash_plan``), on the CPU: the tiling of every (dqk, dv) pair (read
against the kernel source's table), its shared memory and ring, the grid
and row-block order, the KV tiles each row block visits against the keys
that are live for its rows, and attention computed in the plan's tiles and
order (an fp32 online softmax per consumer warpgroup, dead tiles skipped)
against the reference's Pallas kernel in interpret mode and its jnp
``flash_attention`` / ``local_attention``.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_tpu as j_flash
from repro.models import attention as jattn
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (HEAD_DIMS, SMEM_MAX,
                                                 flash_attention_tpu,
                                                 flash_plan, flash_tiling)

NEG_INF = -1e30
N_SM = 132
# fp32 on both sides, sums in another order than the reference's blocks
ATOL = 2e-5


def _kernel_tiling() -> dict:
    """(dqk, dv) -> (warpgroups, keys a tile, stages) as the kernel source
    instantiates them."""
    text = (_build.CSRC / "flash_attention_wgmma.cu").read_text()
    rows = re.findall(r"^REPRO_FLASH_WGMMA_TILING\((\d+), (\d+), (\d+), "
                      r"(\d+), (\d+)\)\s*$", text, re.MULTILINE)
    return {(int(a), int(b)): (int(c), int(d), int(e))
            for a, b, c, d, e in rows}


def test_the_tiling_table_is_the_kernels():
    """Every pair of ``HEAD_DIMS`` has one row in the kernel's tiling
    table, and the plan computes that row."""
    table = _kernel_tiling()
    assert set(table) == set(HEAD_DIMS)
    for pair, row in table.items():
        assert flash_tiling(*pair) == row, pair


@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("dqk,dv", HEAD_DIMS)
def test_every_pair_fits_one_block(dqk, dv, softcap):
    """Shared memory within the H100's 227 KB, a ring of at least two
    stages, 64 query rows a consumer warpgroup and 128 threads each plus
    the producer's, uncapped and capped (one tiling for both objects)."""
    p = flash_plan(1, 8, 2, 512, 512, dqk, dv, softcap=softcap)
    assert p.capped == bool(softcap)
    assert p.smem_bytes <= SMEM_MAX and p.stages >= 2
    assert p.consumers in (1, 2) and p.bq == 64 * p.consumers
    assert p.threads == 128 * (p.consumers + 1)
    assert p.bkv in (64, 128) and p.swizzle == 128
    # one more stage would not fit, unless the ring is already 4 deep
    assert p.stages == 4 or SMEM_MAX < p.smem_bytes + p.bkv * 128 * (
        -(-dqk // 64) + -(-dv // 64)) + 24


@pytest.mark.parametrize("name,B,Hq,Hkv,S,dqk,dv,blocks", [
    ("tinyllama-1.1b", 1, 32, 4, 512, 64, 64, 128),
    ("recurrentgemma-2b", 1, 10, 1, 512, 256, 256, 80),
    ("deepseek-v2-lite-16b", 1, 16, 16, 512, 192, 128, 128),
    ("llava-next-34b", 1, 56, 8, 1024, 128, 128, 448),
    ("musicgen-large", 1, 32, 32, 512, 64, 64, 128)])
def test_main_path_prefill_blocks(name, B, Hq, Hkv, S, dqk, dv, blocks):
    """Each family's prefill layer in about a wave of the 132 SMs or more:
    where a head dim passes 128 a block holds one warpgroup's 64 rows,
    which doubles the hybrid's 10 heads to 80 blocks and MLA's 16 to
    128."""
    p = flash_plan(B, Hq, Hkv, S, S, dqk, dv)
    assert p.blocks == blocks
    assert p.blocks >= 0.6 * N_SM
    assert p.consumers == (1 if max(dqk, dv) > 128 else 2)


# (S, Skv, causal, window, q_offset, dqk, dv): causal, ragged, a later
# chunk (q_offset, S != Skv), a window, a window after an offset, the
# hybrid's window at a length where it cuts the band, non-causal S != Skv
CASES = [(512, 512, True, 0, 0, 64, 64), (300, 300, True, 0, 0, 128, 128),
         (100, 256, True, 0, 156, 64, 64), (512, 1024, True, 0, 512, 64, 64),
         (300, 300, True, 64, 0, 256, 256), (100, 256, True, 64, 156, 24, 16),
         (2560, 2560, True, 2048, 0, 256, 256),
         (100, 300, False, 0, 0, 192, 128), (8, 8, True, 0, 0, 16, 16),
         (1, 37, True, 0, 36, 32, 32), (200, 200, True, 1, 0, 128, 128)]


def _live(S, Skv, causal, window, q_offset, rows):
    """(len(rows), Skv) mask of the keys each query row may attend."""
    qp = q_offset + np.asarray(rows)[:, None]
    kp = np.arange(Skv)[None, :]
    live = np.ones((len(rows), Skv), bool)
    if causal:
        live &= kp <= qp
        if window > 0:
            live &= kp > qp - window
    return live


@pytest.mark.parametrize("S,Skv,causal,window,q_offset,dqk,dv", CASES)
def test_visited_tiles_are_exactly_the_live_ones(S, Skv, causal, window,
                                                 q_offset, dqk, dv):
    """Each row block's tiles hold every key live for one of its rows, and
    each tile holds at least one: no live key is left out, no dead tile is
    loaded."""
    p = flash_plan(1, 4, 2, S, Skv, dqk, dv, causal, window, q_offset)
    for qb in range(p.grid[1]):
        rows = range(qb * p.bq, min((qb + 1) * p.bq, S))
        live = _live(S, Skv, causal, window, q_offset, rows).any(0)
        first, n = p.kv_tiles(qb)
        assert first % p.bkv == 0
        visited = np.zeros(Skv, bool)
        visited[first:first + n * p.bkv] = True
        assert not (live & ~visited).any(), (qb, first, n)
        for t in range(n):
            k0 = first + t * p.bkv
            assert live[k0:k0 + p.bkv].any(), (qb, t)


@pytest.mark.parametrize("S,Skv,causal,window,q_offset,dqk,dv", CASES)
def test_the_grid_covers_every_row_block_once(S, Skv, causal, window,
                                              q_offset, dqk, dv):
    """blockIdx.y runs over every row block once, the heaviest first when
    causal, and the row blocks cover S."""
    p = flash_plan(2, 6, 3, S, Skv, dqk, dv, causal, window, q_offset)
    assert p.grid == (12, -(-S // p.bq))
    assert sorted(p.order) == list(range(p.grid[1]))
    assert (p.grid[1] - 1) * p.bq < S <= p.grid[1] * p.bq
    if causal:
        work = [p.kv_tiles(qb)[1] for qb in p.order]
        assert work == sorted(work, reverse=True)


@pytest.mark.parametrize("S,Skv,causal,window,q_offset,dqk,dv", CASES)
def test_each_warpgroup_computes_its_live_tiles(S, Skv, causal, window,
                                                q_offset, dqk, dv):
    """A warpgroup's tiles hold every key live for its rows; two
    warpgroups both walk all the block's tiles (they take turns), a lone
    one no tile dead for all its rows."""
    p = flash_plan(1, 4, 2, S, Skv, dqk, dv, causal, window, q_offset)
    for qb in range(p.grid[1]):
        first, n = p.kv_tiles(qb)
        for w in range(p.consumers):
            lo, hi = p.warpgroup_tiles(qb, w)
            assert 0 <= lo <= hi <= n
            if p.consumers == 2:
                assert (lo, hi) == (0, n)
            rows = range(qb * p.bq + 64 * w, min(qb * p.bq + 64 * (w + 1), S))
            if not rows:
                assert p.consumers == 2 or lo == hi
                continue
            live = _live(S, Skv, causal, window, q_offset, rows).any(0)
            computed = np.zeros(Skv, bool)
            computed[first + lo * p.bkv:first + hi * p.bkv] = True
            assert not (live & ~computed).any(), (qb, w, lo, hi)
            if p.consumers == 1:
                for t in range(lo, hi):
                    k0 = first + t * p.bkv
                    assert live[k0:k0 + p.bkv].any(), (qb, w, t)


def _blocked(q, k, v, p, softcap=None):
    """Attention in the plan's tiles and order: for each (batch, head) and
    each row block in ``p.order``, each consumer warpgroup's 64 rows take
    the online softmax in fp32 over the tiles it computes
    (``warpgroup_tiles``), masking keys past Skv, above the diagonal and
    below the band.  q (B,Hq,S,dqk), k (B,Hkv,Skv,dqk), v (B,Hkv,Skv,dv)
    as numpy fp32."""
    B, Hq, S, dqk = q.shape
    Hkv, Skv, dv = k.shape[1], k.shape[2], v.shape[3]
    scale = dqk ** -0.5
    out = np.full((B, Hq, S, dv), np.nan, np.float32)
    for b in range(B):
        for h in range(Hq):
            hk = h // (Hq // Hkv)
            for qb in p.order:
                first, n = p.kv_tiles(qb)
                for w in range(p.consumers):
                    r0 = qb * p.bq + 64 * w
                    rows = np.arange(r0, r0 + 64)
                    lo, hi = p.warpgroup_tiles(qb, w)
                    qr = np.zeros((64, dqk), np.float32)  # TMA's zero rows
                    qr[:max(0, min(64, S - r0))] = q[b, h, r0:r0 + 64]
                    m = np.full(64, NEG_INF, np.float32)
                    l = np.zeros(64, np.float32)
                    acc = np.zeros((64, dv), np.float32)
                    for t in range(lo, hi):
                        k0 = first + t * p.bkv
                        keys = np.arange(k0, k0 + p.bkv)
                        kt = np.zeros((p.bkv, dqk), np.float32)
                        vt = np.zeros((p.bkv, dv), np.float32)
                        kt[:max(0, min(p.bkv, Skv - k0))] = k[b, hk, k0:k0 + p.bkv]
                        vt[:max(0, min(p.bkv, Skv - k0))] = v[b, hk, k0:k0 + p.bkv]
                        s = (qr @ kt.T) * np.float32(scale)
                        if softcap is not None:
                            s = np.float32(softcap) * np.tanh(s / softcap)
                        live = keys[None, :] < Skv
                        qp = p.q_offset + rows[:, None]
                        if p.causal:
                            live = live & (keys[None, :] <= qp)
                            if p.window > 0:
                                live = live & (keys[None, :] > qp - p.window)
                        s = np.where(live, s, np.float32(NEG_INF))
                        m_new = np.maximum(m, s.max(1))
                        pr = np.exp(s - m_new[:, None]) * (s > NEG_INF * 0.5)
                        corr = np.exp(m - m_new)
                        l = l * corr + pr.sum(1)
                        acc = acc * corr[:, None] + pr @ vt
                        m = m_new
                    o = acc / np.maximum(l, 1e-30)[:, None]
                    keep = max(0, min(64, S - r0))   # rows < S are stored
                    out[b, h, r0:r0 + keep] = o[:keep]
    return out


def _normal(shape, salt, scale=1.0):
    return (scale * np.random.default_rng([11, salt]).standard_normal(
        shape)).astype(np.float32)


@pytest.mark.parametrize("B,Hq,Hkv,S,dh,causal", [
    (1, 4, 4, 256, 64, True), (2, 4, 2, 256, 128, False),
    (1, 2, 1, 128, 256, True), (1, 4, 2, 64, 32, True),
    (1, 2, 2, 128, 16, False)])
def test_blocked_as_planned_equals_the_pallas_kernel(B, Hq, Hkv, S, dh,
                                                      causal):
    """Square pairs, causal and not, MHA, GQA and MQA: the plan's blocked
    attention against the reference's Pallas kernel in interpret mode."""
    q = _normal((B, Hq, S, dh), 0)
    k, v = _normal((B, Hkv, S, dh), 1), _normal((B, Hkv, S, dh), 2)
    p = flash_plan(B, Hq, Hkv, S, S, dh, dh, causal)
    got = _blocked(q, k, v, p)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, block_q=128, block_kv=128, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


# (S, q_offset, softcap, dqk, dv): a later chunk, a cap that bites (q
# scaled by 4 against a cap of 5), both, MLA's pair and its smoke config's
# padded 24 / 16, and a ragged row block
JNP_CASES = [(128, 128, None, 64, 64), (256, 0, 5.0, 64, 64),
             (100, 156, 5.0, 128, 128), (128, 64, None, 192, 128),
             (200, 56, 5.0, 24, 16), (64, 0, None, 24, 16),
             (100, 28, None, 256, 256)]


@pytest.mark.parametrize("S,q_offset,softcap,dqk,dv", JNP_CASES)
def test_blocked_as_planned_equals_jnp_flash_attention(S, q_offset, softcap,
                                                       dqk, dv):
    """Causal, Skv = q_offset + S keys, GQA 4/2: the plan's blocked
    attention against the reference's jnp ``flash_attention`` (the (B,S,
    H,D) layout), which takes ``q_offset``, ``softcap`` and dv != dqk."""
    Skv = q_offset + S
    q = _normal((1, S, 4, dqk), 3, scale=4.0)
    k, v = _normal((1, Skv, 2, dqk), 4), _normal((1, Skv, 2, dv), 5)
    p = flash_plan(1, 4, 2, S, Skv, dqk, dv, True, 0, q_offset, softcap)
    got = _blocked(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                   v.transpose(0, 2, 1, 3), p, softcap)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), q_offset=q_offset,
                                 softcap=softcap)
    np.testing.assert_allclose(got.transpose(0, 2, 1, 3), np.asarray(want),
                               atol=ATOL)


@pytest.mark.parametrize("S,q_offset,window,dh", [
    (256, 0, 64, 64), (128, 128, 100, 128), (300, 0, 1, 32),
    (256, 0, 200, 256), (100, 156, 64, 24)])
def test_blocked_as_planned_equals_jnp_local_attention(S, q_offset, window,
                                                       dh):
    """A window that cuts the band, after an offset, of one key: against
    the reference's jnp ``local_attention`` (Skv = q_offset + S).  At dh 24
    the key dim is the smoke config's padded one, its values as wide."""
    Skv = q_offset + S
    q = _normal((1, S, 4, dh), 6)
    k, v = _normal((1, Skv, 2, dh), 7), _normal((1, Skv, 2, dh), 8)
    dv = 16 if dh == 24 else dh
    v = v[..., :dv].copy() if dh == 24 else v
    p = flash_plan(1, 4, 2, S, Skv, dh, dv, True, window, q_offset)
    got = _blocked(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                   v.transpose(0, 2, 1, 3), p)
    if dh == 24:                 # local_attention keeps v's width as dh
        vw = np.zeros((1, Skv, 2, dh), np.float32)
        vw[..., :dv] = v
        want = np.asarray(jattn.local_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(vw), window=window,
            q_offset=q_offset))[..., :dv]
    else:
        want = np.asarray(jattn.local_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
            q_offset=q_offset))
    np.testing.assert_allclose(got.transpose(0, 2, 1, 3), want, atol=ATOL)


def test_cpu_call_counts_no_route():
    """On the CPU the wrapper runs the plain version and launches nothing."""
    _build.reset_launches()
    q = torch.ones(1, 2, 8, 64, dtype=torch.bfloat16)
    flash_attention_tpu(q, q, q)
    assert _build.FLASH_ROUTES == {"wgmma": 0, "ffma": 0}
    assert _build.LAUNCHES["flash_attention"] == 0


def test_a_pair_the_kernel_does_not_instantiate_raises():
    with pytest.raises(ValueError):
        flash_plan(1, 2, 2, 8, 8, 48, 48)
