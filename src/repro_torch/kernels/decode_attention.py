"""Flash-decoding: one new query token vs a long KV cache (twin of the
reference's ``kernels/decode_attention.py``).

On a CUDA tensor this launches ``csrc/decode_attention.cu`` once: blocks
over chunks of the live cache (cut by :func:`split_plan`) write partial
softmax results, which the last blocks to finish combine in the same
launch (in runs of at most 16, then the runs).  On a CPU tensor it runs
the plain version in ``kernels/ref.py``, on a meta tensor its shapes
(``kernels/meta.py``).

Layout: q (B,Hq,dh); cache (B,Hkv,S,dh), any strides with a contiguous
last dimension and rows that start 16-byte aligned (the model passes a
``transpose(1, 2)`` view of its (B,S,Hkv,dh) layer cache, no copy);
``pos`` is a host int shared by the batch (the reference scalar-prefetches
it).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build, meta, ref

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)  # instantiated in csrc/decode_attention.cu
HEADS_PER_BLOCK = 4   # query heads a block keeps in registers (GM)
SPLIT_ALIGN = 16      # a chunk is a multiple of this many positions
FAN = 16              # partials one block of the combine folds (FAN)

# per device: the int32 counters by which the kernel's last blocks find
# themselves, (n_run + 1) per (batch, kv head, head group); zero between
# launches, because the block that counts last resets each
_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def chunk_min(G: int, dh: int, itemsize: int = 2) -> int:
    """The shortest chunk worth a block: a split writes a partial of
    G*dh*4 bytes (fp32 acc, m and l are noise) and a chunk of c positions
    reads 2*c*dh*itemsize bytes of cache, so below c = 2*G/itemsize the
    partial outgrows the cache bytes it summarises.  Rounded up to a
    multiple of 16, at least 16 (G 10, bf16: 10 positions -> 16)."""
    floor = _cdiv(G * dh * 4, 2 * dh * itemsize)
    return max(SPLIT_ALIGN, _cdiv(floor, SPLIT_ALIGN) * SPLIT_ALIGN)


def split_plan(B: int, Hkv: int, live: int, G: int, dh: int,
               n_sm: int = 132, itemsize: int = 2) -> Tuple[int, int]:
    """(chunk, n_split) for ``live`` = pos + 1 cache positions: chunks of
    ``chunk`` positions (a multiple of 16, at least :func:`chunk_min`)
    tile [0, live) with ``n_split`` non-empty pieces.  The chunk is the
    largest multiple of 16 that still gives B*Hkv*n_split >= n_sm blocks,
    so the grid fills the card where the cache allows (it reaches
    min(n_sm, B*Hkv*ceil(live/chunk_min))) and no further: n_split stays
    within 2*ceil(n_sm/(B*Hkv)) + 1, whatever the cache's length."""
    if live < 1:
        raise ValueError(f"live={live}: at least one position")
    lo = chunk_min(G, dh, itemsize)
    fill = _cdiv(n_sm, B * Hkv)            # splits a (b, kv head) to fill
    chunk = max(lo, live // (SPLIT_ALIGN * fill) * SPLIT_ALIGN)
    return chunk, _cdiv(live, chunk)


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """The device's zeroed counters, grown to ``n``.  Make them with an
    eager call before capturing a decode step in a CUDA graph."""
    t = _COUNTERS.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _COUNTERS[device] = t
    return t


def decode_attention_tpu(q, k_cache, v_cache, pos, *, block_s: int = 1024):
    """q (B,Hq,dh), k/v_cache (B,Hkv,S,dh), pos int -> (B,Hq,dh).

    ``block_s`` keeps the reference's divisibility assert; the CUDA
    kernel splits the live cache by :func:`split_plan`.
    """
    _build.check_no_grad("decode_attention_tpu", q, k_cache, v_cache)
    B, Hq, dh = q.shape
    _, Hkv, S, _ = k_cache.shape
    G = Hq // Hkv
    bs = min(block_s, S)
    assert S % bs == 0
    pos = int(pos)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, pos)
    if q.device.type == "meta":
        return meta.decode_attention(q, k_cache, v_cache, pos)
    if Hq % Hkv != 0:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if not 0 <= pos < S:
        raise ValueError(f"pos={pos} outside the cache [0, {S})")
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
    code = _build.dtype_code(q)
    _build.check_aligned(q, k_cache, v_cache)   # 16-byte row loads
    chunk, n_split = split_plan(
        B, Hkv, pos + 1, G, dh, itemsize=q.element_size(),
        n_sm=torch.cuda.get_device_properties(q.device).multi_processor_count)
    n_grp = _cdiv(G, HEADS_PER_BLOCK)
    n_run = _cdiv(n_split, FAN)
    # scratch: (m, l, acc) partials of every split and of every run of FAN
    part = torch.empty(B * Hkv * (n_split + n_run) * G * (dh + 2),
                       dtype=torch.float32, device=q.device)
    counters = _counters(q.device, B * Hkv * n_grp * (n_run + 1))
    out = torch.empty((B, Hq, dh), dtype=q.dtype, device=q.device)
    err = _build.lib().repro_decode_attention(
        code, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        out.data_ptr(), part.data_ptr(), counters.data_ptr(), B, Hkv, G, dh,
        pos, chunk, n_split, n_grp, q.stride(0), q.stride(1),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2), dh ** -0.5,
        _build.stream_ptr(q))
    _build.check(err, "repro_decode_attention")
    _build.LAUNCHES["decode_attention"] += 1
    return out
