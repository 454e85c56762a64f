"""The decode kernel's cluster plan (``kernels/decode_attention.py``), on
the CPU: how the live cache is cut into chunks, one CTA of a (batch, kv
head)'s cluster each, how the G heads split over the CTA's warps, what
its shared memory holds, and that partial softmax results over the
plan's chunks, folded in rank order as the cluster folds them, give the
reference's decode attention.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.decode_attention import decode_attention_tpu as j_decode
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels.decode_attention import (DecodePlan, cluster_plan,
                                                  edge_positions, head_split,
                                                  padded_heads, smem_bytes,
                                                  split_cost)

N_SM = 132


def _chunks(plan, live):
    return [(s * plan.chunk, min((s + 1) * plan.chunk, live))
            for s in range(plan.n_split)]


@pytest.mark.parametrize("live", [1, 64, 536, 2048])
@pytest.mark.parametrize("B,Hkv", [(1, 1), (1, 4), (2, 2)])
@pytest.mark.parametrize("G,dh,itemsize", [(8, 64, 2), (10, 256, 2),
                                           (10, 256, 4), (32, 64, 2)])
def test_cluster_plan_tiles_the_live_cache(B, Hkv, live, G, dh, itemsize):
    plan = cluster_plan(B, Hkv, live, G, dh, n_sm=N_SM, itemsize=itemsize)
    # [s*chunk, min((s+1)*chunk, live)) for s < n_split: each position once
    covered = np.zeros(live, np.int64)
    for s, (lo, hi) in enumerate(_chunks(plan, live)):
        assert hi > lo, f"CTA {s} is empty"
        covered[lo:hi] += 1
    assert (covered == 1).all()
    # the shortest multiple of 16 that covers live in n_split chunks
    assert plan.chunk == -(-(-(-live // plan.n_split)) // 16) * 16
    # within the cluster limit, no cluster without heads, one CTA a
    # multiprocessor at most
    hps = -(-G // plan.head_splits)
    assert 1 <= plan.n_split <= 16 and -(-G // hps) == plan.head_splits
    assert B * Hkv * plan.head_splits * plan.n_split <= N_SM
    assert plan.tile_rows % 16 == 0 and 16 <= plan.tile_rows <= min(
        plan.chunk, 64)
    assert 2 <= plan.stages <= 4
    assert smem_bytes(hps, dh, itemsize, plan.tile_rows,
                      plan.stages) <= dec.SMEM_LIMIT
    # no candidate of the search costs less
    for n in range(1, 17):
        chunk = -(-(-(-live // n)) // 16) * 16
        for h in range(1, G + 1):
            k = -(-G // h)
            ctas = B * Hkv * h * -(-live // chunk)
            if -(-G // k) == h and ctas <= N_SM:
                assert split_cost(plan.chunk, dh, hps, B * Hkv *
                                  plan.head_splits * plan.n_split) <= \
                    split_cost(chunk, dh, k, ctas)


@pytest.mark.parametrize("B,Hkv,n_sm", [(1, 132, 132), (4, 64, 132),
                                        (2, 2, 4), (8, 40, 132)])
def test_a_card_full_of_clusters_splits_no_further(B, Hkv, n_sm):
    """One CTA a kv head, with all its heads, where B*Hkv fills the
    card."""
    plan = cluster_plan(B, Hkv, 4096, 8, 64, n_sm=n_sm)
    assert (plan.n_split, plan.head_splits) == (1, 1)


@pytest.mark.parametrize("B,Hkv,n_sm", [(1, 66, 132), (1, 8, 132),
                                        (1, 32, 132)])
def test_the_clusters_stay_within_the_card(B, Hkv, n_sm):
    plan = cluster_plan(B, Hkv, 4096, 8, 64, n_sm=n_sm)
    assert plan.n_split * plan.head_splits > 1
    assert B * Hkv * plan.n_split * plan.head_splits <= n_sm


@pytest.mark.parametrize("max_cluster", [1, 8, 16])
@pytest.mark.parametrize("live", [536, 1024, 2048])
def test_the_cluster_limit_caps_the_split(max_cluster, live):
    """A card that schedules no cluster over ``max_cluster`` CTAs (8: the
    portable size; 16 where the card allows it) gets none; with one CTA a
    cluster the heads may still split over clusters."""
    def fits(n_split, heads, rows, stages, clusters):
        return n_split <= max_cluster

    plan = cluster_plan(1, 1, live, 10, 256, fits=fits)
    assert plan.n_split <= max_cluster
    assert plan.chunk * plan.n_split >= live
    assert plan.n_split * plan.head_splits > 1


@pytest.mark.parametrize("live", [2113, 4223, 100_000, 1 << 20])
def test_a_long_cache_gets_longer_chunks_not_more_ctas(live):
    """Past what fills the card the chunk grows; a chunk longer than the
    ring walks through it."""
    plan = cluster_plan(1, 1, live, 8, 64)
    assert plan.n_split <= 16
    assert plan.n_split * plan.head_splits <= N_SM
    assert (plan.n_split - 1) * plan.chunk < live <= plan.n_split * plan.chunk
    tiles = -(-plan.chunk // plan.tile_rows)
    assert plan.tile_rows == 64 and plan.stages == min(4, tiles)
    assert (tiles > plan.stages) == (plan.chunk > 4 * 64)


@pytest.mark.parametrize("room,want", [(16, 16), (12, 12), (9, 9), (1, 1)])
def test_the_plan_takes_no_split_whose_clusters_do_not_fit(room, want):
    """``fits`` (the card's count of clusters it holds at once) rules out
    clusters of more than ``room`` CTAs: TinyLlama's 4 kv heads over
    2048 positions, the heads kept whole."""
    asked = []

    def fits(n_split, heads, rows, stages, clusters):
        asked.append((n_split, heads, clusters))
        return n_split <= room and heads == 8

    plan = cluster_plan(1, 4, 2048, 8, 64, fits=fits)
    assert plan.head_splits == 1 and plan.n_split == want
    assert all(c == 4 * -(-8 // h) for _, h, c in asked)


def test_the_plan_asks_nothing_of_a_lone_cta():
    plan = cluster_plan(1, 4, 16, 8, 64, fits=lambda *a: False)
    assert plan == DecodePlan(16, 1, 16, 2, 1)


@pytest.mark.parametrize("G,want", [(1, (1, 1, 1, 8, 1)),
                                    (7, (4, 2, 2, 4, 1)),
                                    (8, (4, 2, 2, 4, 1)),
                                    (10, (5, 2, 2, 4, 1)),
                                    (32, (5, 7, 7, 1, 1)),
                                    (64, (5, 13, 8, 1, 2))])
def test_head_split_over_the_warps(G, want):
    """(heads a group, groups, groups a pass, warps a group, passes): the
    groups hold every head once, at most 5 each, within 8 warps a pass."""
    hpg, n_hg, gpp, n_ks, passes = head_split(G)
    assert (hpg, n_hg, gpp, n_ks, passes) == want
    assert hpg <= dec.HEADS_PER_WARP and (n_hg - 1) * hpg < G <= n_hg * hpg
    assert gpp * n_ks <= dec.WARPS and gpp * passes >= n_hg


@pytest.mark.parametrize("name,value", [
    ("WARPS", dec.WARPS), ("GM", dec.HEADS_PER_WARP),
    ("MAX_CLUSTER", dec.MAX_CLUSTER), ("MAX_STAGES", dec.MAX_STAGES),
    ("SMEM_LIMIT", dec.SMEM_LIMIT)])
def test_the_plan_reads_the_kernel_constants(name, value):
    text = (_build.CSRC / "decode_attention.cu").read_text()
    got = re.search(r"constexpr int %s = (\d+);" % name, text)
    assert got and int(got.group(1)) == value


def test_head_dims_are_the_kernel_dispatch():
    text = (_build.CSRC / "decode_attention.cu").read_text()
    cases = re.findall(r"case (\d+): return CALL\(\1\);", text)
    assert tuple(int(c) for c in cases) == dec.HEAD_DIMS


@pytest.mark.parametrize("G,dh,itemsize,rows,stages,want", [
    (8, 64, 2, 64, 2, 2 * 2 * 64 * 64 * 2 + 8 * 5 * 66 * 4
     + (8 * 16 + 16) * 24 + 32 + 128),
    (10, 256, 4, 16, 4, 4 * 2 * 16 * 1024 + 8 * 5 * 258 * 4
     + (10 * 64 + 16) * 24 + 64 + 128)])
def test_smem_bytes_adds_up_the_layout(G, dh, itemsize, rows, stages, want):
    assert smem_bytes(G, dh, itemsize, rows, stages) == want


def test_too_many_heads_for_shared_memory_are_refused():
    with pytest.raises(ValueError):
        cluster_plan(1, 1, 64, 256, 256, itemsize=4, n_sm=1)


@pytest.mark.parametrize("heads,want", [(1, 1), (2, 4), (4, 4), (5, 5),
                                        (7, 8), (8, 8), (10, 10), (48, 50)])
def test_padded_heads_are_the_consumer_instantiations(heads, want):
    """A group of 1 head runs the 1-head consumer, of 2-4 the 4-head one,
    of 5 the 5-head one: what a cluster's warps compute."""
    assert padded_heads(heads) == want


def test_edge_positions_hit_the_plan_edges():
    """Positions where the last chunk holds one key, fills its chunk, or
    sits at a tile edge, and where a chunk outgrows the ring."""
    S = 2048

    def plan_of(pos):
        return cluster_plan(1, 1, pos + 1, 10, 256)
    got = edge_positions(plan_of, S)
    assert {0, 535, S - 1} <= set(got) and got == sorted(set(got))
    kinds = set()
    for pos in got:
        p = plan_of(pos)
        last = pos + 1 - (p.n_split - 1) * p.chunk
        kinds |= {k for k, hit in (
            ("one", p.n_split > 1 and last == 1),
            ("full", p.n_split > 1 and last == p.chunk),
            ("tile", last > p.tile_rows and last % p.tile_rows in (0, 1)),
            ("walk", -(-p.chunk // p.tile_rows) > p.stages)) if hit}
    assert kinds == {"one", "full", "tile", "walk"}


def _partial(s, v):
    """(m, l, acc) of scores s (..., n) over values v (..., n, dh)."""
    m = s.max(-1)
    p = np.exp(s - m[..., None])
    return m, p.sum(-1), np.einsum("bhs,bhsd->bhd", p, v)


def _cluster_combine(q, k, v, pos, plan):
    """The kernel's arithmetic in numpy float64: each CTA's partial (m, l,
    acc) over its chunk, folded in rank order in one level."""
    B, Hq, dh = q.shape
    G = Hq // k.shape[1]
    kr = np.repeat(k, G, axis=1)[:, :, :pos + 1]
    vr = np.repeat(v, G, axis=1)[:, :, :pos + 1]
    s = np.einsum("bhd,bhsd->bhs", q, kr) * dh ** -0.5
    parts = [_partial(s[:, :, lo:hi], vr[:, :, lo:hi])
             for lo, hi in _chunks(plan, pos + 1)]
    M = np.max([m for m, _, _ in parts], axis=0)
    L = sum(l * np.exp(m - M) for m, l, _ in parts)
    acc = sum(a * np.exp(m - M)[..., None] for m, _, a in parts)
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
    plan = cluster_plan(B, Hkv, pos + 1, Hq // Hkv, dh)
    got = _cluster_combine(q.astype(np.float64), k.astype(np.float64),
                           v.astype(np.float64), pos, plan)
    want = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos,
                    block_s=min(1024, S), interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-5)


def test_plan_rejects_an_empty_cache():
    with pytest.raises(ValueError):
        cluster_plan(1, 1, 0, 8, 64)
