"""The decode kernel's split plan (``kernels/decode_attention.py``), on the
CPU: how the live cache is cut into chunks, one block each, and that
partial softmax results over those chunks, combined as the kernel's last
block combines them, give the reference's decode attention.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.decode_attention import decode_attention_tpu as j_decode
from repro_torch.kernels.decode_attention import FAN, chunk_min, split_plan

N_SM = 132


@pytest.mark.parametrize("live", [1, 64, 536, 2048])
@pytest.mark.parametrize("B,Hkv", [(1, 1), (1, 4), (2, 2)])
@pytest.mark.parametrize("G,dh,itemsize", [(8, 64, 2), (10, 256, 2),
                                           (10, 256, 4), (32, 64, 2)])
def test_split_plan_tiles_the_live_cache_and_fills_the_card(
        B, Hkv, live, G, dh, itemsize):
    chunk, n_split = split_plan(B, Hkv, live, G, dh, n_sm=N_SM,
                                itemsize=itemsize)
    floor = chunk_min(G, dh, itemsize)
    assert chunk % 16 == 0 and chunk >= floor
    # [s*chunk, min((s+1)*chunk, live)) for s < n_split: each position once
    covered = np.zeros(live, np.int64)
    for s in range(n_split):
        lo, hi = s * chunk, min((s + 1) * chunk, live)
        assert hi > lo, f"split {s} is empty"
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert B * Hkv * n_split >= min(N_SM, B * Hkv * -(-live // floor))
    assert n_split <= 2 * -(-N_SM // (B * Hkv)) + 1


@pytest.mark.parametrize("G,itemsize,want", [(8, 2, 16), (10, 2, 16),
                                             (10, 4, 16), (32, 2, 32),
                                             (17, 2, 32), (1, 4, 16)])
def test_chunk_min_is_where_the_partial_outgrows_the_cache_read(
        G, itemsize, want):
    dh = 64
    got = chunk_min(G, dh, itemsize)
    assert got == want and got % 16 == 0
    # the partial (G*dh fp32) is no larger than the chunk's K and V bytes
    assert G * dh * 4 <= 2 * got * dh * itemsize


def test_hybrid_decode_fills_more_blocks_than_fixed_chunks():
    """recurrentgemma-2b at ring position 535 (G 10, dh 256, one KV head):
    fixed 64-position chunks ran 9 blocks."""
    chunk, n_split = split_plan(1, 1, 536, 10, 256)
    assert (chunk, n_split) == (16, 34) and n_split > 536 // 64 + 1


@pytest.mark.parametrize("live", [2113, 4223, 100_000, 1 << 20])
def test_a_long_cache_gets_longer_chunks_not_more_splits(live):
    """Past what fills the card the chunk grows: the last block's combine
    reads n_split partials, so their count stays near n_sm."""
    chunk, n_split = split_plan(1, 1, live, 8, 64)
    assert N_SM <= n_split <= 2 * N_SM + 1
    assert (n_split - 1) * chunk < live <= n_split * chunk


def _fold(ms, ls, accs):
    """(m, l, acc) partials folded into one, as a block of the combine
    folds them."""
    M = np.max(ms, axis=0)
    w = [np.exp(m - M) for m in ms]
    return (M, sum(li * wi for li, wi in zip(ls, w)),
            sum(a * wi[..., None] for a, wi in zip(accs, w)))


def _split_combine(q, k, v, pos, chunk, n_split):
    """The kernel's arithmetic in numpy float64: each split's partial
    (m, l, acc) over its chunk, folded in runs of FAN, then the runs."""
    B, Hq, dh = q.shape
    G = Hq // k.shape[1]
    kr = np.repeat(k, G, axis=1)[:, :, :pos + 1]
    vr = np.repeat(v, G, axis=1)[:, :, :pos + 1]
    s = np.einsum("bhd,bhsd->bhs", q, kr) * dh ** -0.5
    parts = []
    for sp in range(n_split):
        sl = slice(sp * chunk, min((sp + 1) * chunk, pos + 1))
        m = s[:, :, sl].max(-1)
        p = np.exp(s[:, :, sl] - m[..., None])
        parts.append((m, p.sum(-1), np.einsum("bhs,bhsd->bhd", p,
                                              vr[:, :, sl])))
    runs = [_fold(*zip(*parts[i:i + FAN])) for i in range(0, n_split, FAN)]
    _, L, acc = _fold(*zip(*runs))
    return acc / np.maximum(L, 1e-30)[..., None]


@pytest.mark.parametrize("B,Hq,Hkv,S,dh", [(1, 32, 4, 1024, 64),
                                           (1, 10, 1, 2048, 256),
                                           (2, 8, 2, 1024, 64)])
@pytest.mark.parametrize("pos", [0, 15, 16, 535, 1023])
def test_plan_chunks_combined_equal_the_reference(B, Hq, Hkv, S, dh, pos):
    rng = np.random.default_rng([7, pos])
    q = rng.standard_normal((B, Hq, dh)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, dh)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, dh)).astype(np.float32)
    chunk, n_split = split_plan(B, Hkv, pos + 1, Hq // Hkv, dh)
    got = _split_combine(q.astype(np.float64), k.astype(np.float64),
                         v.astype(np.float64), pos, chunk, n_split)
    want = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos,
                    block_s=min(1024, S), interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-5)


def test_plan_rejects_an_empty_cache():
    with pytest.raises(ValueError):
        split_plan(1, 1, 0, 8, 64)
