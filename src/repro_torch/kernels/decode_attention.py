"""Flash-decoding: one new query token vs a long KV cache (twin of the
reference's ``kernels/decode_attention.py``).

On a CUDA tensor this launches ``csrc/decode_attention.cu`` once: one
thread-block cluster a (batch, kv head, share of its query heads), its
CTAs over chunks of the live cache (both cut by :func:`cluster_plan`), K
and V tiles brought in by TMA, and the chunks' partial softmax results
combined inside the cluster through distributed shared memory.  Nothing but the output is allocated, so a
call can be captured in a CUDA graph as it is.  On a CPU tensor it runs
the plain version in ``kernels/ref.py``, on a meta tensor its shapes
(``kernels/meta.py``).

Layout: q (B,Hq,dh); cache (B,Hkv,S,dh), any strides with a contiguous
last dimension and every base and stride a multiple of 16 bytes (the
model passes a ``transpose(1, 2)`` view of its (B,S,Hkv,dh) layer cache,
no copy); ``pos`` is shared by the batch (the reference scalar-prefetches
it): a host int, or a 0-d int64 tensor on q's device that the kernel
reads when it starts.  With a device ``pos`` the caller names ``pos_top``,
the last position the launch may meet, and the launch takes the plan for
``pos_top`` (chunks past ``pos`` read nothing), so a CUDA graph that
captures it replays at any position up to ``pos_top``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build, meta, ref
from repro_torch.runtime import trace

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)  # instantiated in csrc/decode_attention.cu
# the kernel's constants (csrc/decode_attention.cu)
WARPS = 8             # consumer warps of a CTA (and one producer warp)
HEADS_PER_WARP = 5    # query heads a consumer warp keeps in registers (GM)
MAX_CLUSTER = 16      # CTAs a cluster, non-portable (8 portable)
MAX_STAGES = 4        # the K/V ring's stages, at most
SMEM_LIMIT = 232448   # shared memory a block may use
# the plan's choices
SPLIT_ALIGN = 16      # a chunk is a multiple of this many positions
TILE_BYTES = 8192     # an operand tile's bytes, at most (but 16 rows)
MAX_TILE_ROWS = 64

# per (device, dtype, dh, heads a cluster, tile rows, stages, cluster
# size): how many such clusters the card holds at once
# (cudaOccupancyMaxActiveClusters); per (device, dtype, B, Hkv, G, dh,
# pos): the plan the wrapper launches (its search takes ~0.2 ms of host
# time, a decode step's layers share a position)
_ACTIVE: Dict[tuple, int] = {}
_PLANS: Dict[tuple, "DecodePlan"] = {}


class DecodePlan(NamedTuple):
    """``n_split`` chunks of ``chunk`` positions, one CTA each, in a
    cluster; the G heads of a kv head split over ``head_splits`` clusters;
    each CTA walks its chunk in tiles of ``tile_rows`` rows through a ring
    of ``stages``."""
    chunk: int
    n_split: int
    tile_rows: int
    stages: int
    head_splits: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def head_split(G: int) -> Tuple[int, int, int, int, int]:
    """(hpg, n_hg, gpp, n_ks, passes): the G heads of a cluster go to
    n_hg groups of hpg heads (balanced, at most HEADS_PER_WARP), gpp
    groups a pass over the chunk, each group taken by n_ks consumer warps
    that split the keys (the kernel's ``Heads``)."""
    n = _cdiv(G, HEADS_PER_WARP)
    hpg = _cdiv(G, n)
    n_hg = _cdiv(G, hpg)
    gpp = min(n_hg, WARPS)
    return hpg, n_hg, gpp, WARPS // gpp, _cdiv(n_hg, gpp)


def smem_bytes(G: int, dh: int, itemsize: int, tile_rows: int,
               stages: int) -> int:
    """The kernel's dynamic shared memory (its ``Layout``) for clusters of
    G heads: the ring, the warps' partials, the slots into which the
    cluster's CTAs push their partials of this CTA's (head, 4-column)
    outputs (16 + 8 bytes each, as many as there are outputs, plus one a
    rank for the rounding), the barriers and 128 bytes to align the
    base."""
    tile = tile_rows * dh * itemsize
    slots = G * dh // 4 + MAX_CLUSTER
    end = stages * 2 * tile + WARPS * HEADS_PER_WARP * (dh + 2) * 4 \
        + slots * 24
    return _cdiv(end, 8) * 8 + stages * 2 * 8 + 128


def max_tile_rows(dh: int, itemsize: int) -> int:
    """The most rows an operand tile takes: TILE_BYTES of them, a multiple
    of 16, between 16 and MAX_TILE_ROWS."""
    rows = TILE_BYTES // (dh * itemsize) // SPLIT_ALIGN * SPLIT_ALIGN
    return max(SPLIT_ALIGN, min(MAX_TILE_ROWS, rows))


def _tiles(chunk: int, hps: int, dh: int, itemsize: int) -> Tuple[int, int]:
    """(tile rows, stages) for a chunk and clusters of hps heads: tiles of
    the chunk or :func:`max_tile_rows`, whichever is shorter; as many
    stages as the chunk has tiles (every pass over the heads), between 2
    and MAX_STAGES, fewer where shared memory runs out."""
    rows = min(chunk, max_tile_rows(dh, itemsize))
    stages = min(MAX_STAGES,
                 max(2, _cdiv(chunk, rows) * head_split(hps)[4]))
    while stages > 1 and smem_bytes(hps, dh, itemsize, rows,
                                    stages) > SMEM_LIMIT:
        stages -= 1
    if smem_bytes(hps, dh, itemsize, rows, stages) > SMEM_LIMIT:
        raise ValueError(f"{hps} heads of dh {dh} do not fit one block's "
                         "shared memory")
    return rows, stages


@functools.lru_cache(maxsize=None)
def padded_heads(heads: int) -> int:
    """The heads a cluster of ``heads`` works in its warps' registers:
    each group of its :func:`head_split` padded to 1, 4 or
    HEADS_PER_WARP (the kernel's consumer instantiations)."""
    hpg, n_hg = head_split(heads)[:2]
    return n_hg * (1 if hpg == 1 else 4 if hpg <= 4 else HEADS_PER_WARP)


# the plan's cost of a split, in microseconds of an H100's device time:
# a CTA's cache bytes (chunk x dh) and its heads' arithmetic (chunk x dh
# x padded heads), per head of a cluster (q, merges and pushes), per CTA
# of the grid (decode_split_sweep.py fits them to every split of its
# rows and reports how far the plan's pick lands from the fastest)
COST_ROW_DH = 0.837e-4
COST_ROW_DH_HEAD = 0.320e-4
COST_HEAD = 0.262
COST_CTA = 0.00857


def split_cost(chunk: int, dh: int, heads: int, ctas: int) -> float:
    """The plan's estimate of a split's device time, less a constant."""
    return (chunk * dh * (COST_ROW_DH + COST_ROW_DH_HEAD * padded_heads(heads))
            + COST_HEAD * heads + COST_CTA * ctas)


@functools.lru_cache(maxsize=None)
def _head_shares(G: int) -> Tuple[Tuple[int, int], ...]:
    """(head_splits, heads a cluster) for every split of G heads into
    clusters of ceil(G / head_splits) that leaves none empty."""
    return tuple((h, _cdiv(G, h)) for h in range(1, G + 1)
                 if _cdiv(G, _cdiv(G, h)) == h)


def cluster_plan(B: int, Hkv: int, live: int, G: int, dh: int,
                 n_sm: int = 132, itemsize: int = 2,
                 fits: Optional[Callable[[int, int, int, int, int], bool]]
                 = None) -> DecodePlan:
    """The plan for ``live`` = pos + 1 cache positions.

    The candidates: n_split at most MAX_CLUSTER CTAs a cluster, each
    chunk the shortest multiple of 16 that covers [0, live) with them
    (none empty; a longer cache gets longer chunks, not more CTAs); the G
    heads of a kv head in head_splits clusters of ceil(G / head_splits)
    heads (none empty); at most ``n_sm`` CTAs in all, one a multiprocessor
    (a single CTA a kv head where B*Hkv fills the card).  The plan takes
    the candidate of least :func:`split_cost`, ties to fewer CTAs, then
    fewer head splits (each reads the cache again from L2).
    ``fits(n_split, heads, tile_rows, stages, clusters)``, where given,
    says whether the card holds that many such clusters at once (the
    wrapper asks the card); a candidate whose clusters do not fit is not
    taken.
    """
    if live < 1:
        raise ValueError(f"live={live}: at least one position")
    groups = B * Hkv
    best, best_key = None, None
    for n in range(1, MAX_CLUSTER + 1):
        chunk = _cdiv(_cdiv(live, n), SPLIT_ALIGN) * SPLIT_ALIGN
        n_split = _cdiv(live, chunk)
        for h, hps in _head_shares(G):
            ctas = groups * h * n_split
            if ctas > n_sm and n_split * h > 1:
                continue
            key = (split_cost(chunk, dh, hps, ctas), ctas, h)
            if best_key is not None and key >= best_key:
                continue
            rows, stages = _tiles(chunk, hps, dh, itemsize)
            if n_split * h > 1 and fits is not None \
                    and not fits(n_split, hps, rows, stages, groups * h):
                continue
            best = DecodePlan(chunk, n_split, rows, stages, h)
            best_key = key
    return best


def edge_positions(plan_of: Callable[[int], DecodePlan], S: int) -> list:
    """Positions of a cache of S slots at which the plan's edges fall
    (``plan_of(pos)``: the plan at ``pos``): 0, 535 (where S allows) and
    S - 1, and the first position at which the last chunk holds one key,
    fills its chunk or ends at or one past a tile edge, and at which a
    chunk outgrows the ring."""
    want = {0, min(535, S - 1), S - 1}
    seen = set()
    for pos in range(S):
        p = plan_of(pos)
        last = pos + 1 - (p.n_split - 1) * p.chunk
        for kind, hit in (
                ("one", p.n_split > 1 and last == 1),
                ("full", p.n_split > 1 and last == p.chunk),
                ("tile", last > p.tile_rows and last % p.tile_rows < 2),
                ("walk", _cdiv(p.chunk, p.tile_rows) > p.stages)):
            if hit and kind not in seen:
                seen.add(kind)
                want.add(pos)
    return sorted(want)


def _fits(q: torch.Tensor):
    """``fits`` for :func:`cluster_plan`: whether the card holds that
    many clusters of that shape at once, asked once per shape
    (cudaOccupancyMaxActiveClusters) and kept."""
    def fits(n_split: int, heads: int, rows: int, stages: int,
             clusters: int) -> bool:
        key = (q.device, q.dtype, q.shape[-1], heads, rows, stages, n_split)
        if key not in _ACTIVE:
            count = ctypes.c_int(0)
            err = _build.lib().repro_decode_active_clusters(
                _build.dtype_code(q), q.shape[-1], heads, rows, stages,
                n_split, ctypes.addressof(count))
            _build.check(err, "repro_decode_active_clusters")
            _ACTIVE[key] = count.value
        return _ACTIVE[key] >= clusters
    return fits


def plan_for(q, k_cache, pos: int) -> DecodePlan:
    """The plan the wrapper launches for these tensors on the card."""
    B, Hq, dh = q.shape
    Hkv = k_cache.shape[1]
    key = (q.device, q.dtype, B, Hkv, Hq // Hkv, dh, pos)
    if key not in _PLANS:
        if trace.ON:
            trace.count("kernel.decode_plan_miss")
        n_sm = torch.cuda.get_device_properties(
            q.device).multi_processor_count
        _PLANS[key] = cluster_plan(B, Hkv, pos + 1, Hq // Hkv, dh,
                                   n_sm=n_sm, itemsize=q.element_size(),
                                   fits=_fits(q))
    return _PLANS[key]


def launch_plan(q, k_cache, v_cache, pos, plan: DecodePlan,
                pos_top: Optional[int] = None):
    """One launch of the kernel with ``plan`` (any plan the kernel takes,
    for sweeps and checks of the plan's alternatives); counts no launch.
    ``pos`` a host int, or a device tensor with ``plan`` the plan for
    ``pos_top``.  The arguments are those the wrapper has checked."""
    B, Hq, dh = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty((B, Hq, dh), dtype=q.dtype, device=q.device)
    at = (int(pos_top), pos.data_ptr()) if isinstance(pos, torch.Tensor) \
        else (int(pos), None)
    err = _build.lib().repro_decode_attention(
        _build.dtype_code(q), q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), out.data_ptr(), B, Hkv, Hq // Hkv, dh, S, *at,
        plan.chunk, plan.n_split, plan.head_splits, plan.tile_rows,
        plan.stages, q.stride(0), q.stride(1), k_cache.stride(0),
        k_cache.stride(1), k_cache.stride(2), v_cache.stride(0),
        v_cache.stride(1), v_cache.stride(2), dh ** -0.5,
        _build.stream_ptr(q))
    _build.check(err, "repro_decode_attention")
    return out


def decode_attention_tpu(q, k_cache, v_cache, pos, *, block_s: int = 1024,
                         pos_top: Optional[int] = None):
    """q (B,Hq,dh), k/v_cache (B,Hkv,S,dh), pos -> (B,Hq,dh).

    ``pos`` is a host int, which the launch plans for, or a 0-d int64
    tensor on q's device, which the kernel reads when it starts: then the
    launch takes the plan for ``pos_top`` (on the card and the meta
    device; the CPU needs none), and the position must not pass it.
    ``block_s`` keeps the reference's divisibility assert; the CUDA
    kernel splits the live cache by :func:`cluster_plan`.
    """
    _build.check_no_grad("decode_attention_tpu", q, k_cache, v_cache)
    B, Hq, dh = q.shape
    _, Hkv, S, _ = k_cache.shape
    bs = min(block_s, S)
    assert S % bs == 0
    on_device = isinstance(pos, torch.Tensor)
    if not on_device:
        pos = int(pos)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, pos)
    if on_device and pos_top is None:
        raise ValueError("a position on the device needs pos_top")
    top = int(pos_top) if on_device else pos
    if q.device.type == "meta":
        return meta.decode_attention(q, k_cache, v_cache, top)
    if Hq % Hkv != 0:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if not 0 <= top < S:
        raise ValueError(f"pos={top} outside the cache [0, {S})")
    if on_device and (pos.shape != () or pos.dtype != torch.int64
                      or pos.device != q.device):
        raise ValueError("a position on the device is a 0-d int64 tensor "
                         "on q's device")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError("q, k_cache and v_cache dtypes differ")
    if v_cache.shape != k_cache.shape:
        raise ValueError("k_cache and v_cache shapes differ")
    for t in (q, k_cache, v_cache):
        if t.stride(-1) != 1 or t.device != q.device:
            raise ValueError("decode kernel needs a contiguous last dim "
                             "and one device")
    _build.dtype_code(q)
    _build.check_aligned(q, k_cache, v_cache)   # TMA: 16-byte bases, strides
    out = launch_plan(q, k_cache, v_cache, pos, plan_for(q, k_cache, top),
                      top)
    _build.LAUNCHES["decode_attention"] += 1
    return out
