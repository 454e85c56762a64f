"""Flash-decoding: one new query token vs a long KV cache (twin of the
reference's ``kernels/decode_attention.py``).

On a CUDA tensor this launches ``csrc/decode_attention.cu``: split-S
partial softmax blocks over the live part of the cache, then a combine
kernel.  On a CPU tensor it runs the plain version in ``kernels/ref.py``.

Layout: q (B,Hq,dh); cache (B,Hkv,S,dh), any strides with a contiguous
last dimension (the model passes a ``transpose(1, 2)`` view of its
(B,S,Hkv,dh) layer cache, no copy); ``pos`` is a host int shared by the
batch (the reference scalar-prefetches it).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

NEG_INF = -1e30
CHUNK = 64          # cache positions per block (csrc/decode_attention.cu)


def decode_attention_tpu(q, k_cache, v_cache, pos, *, block_s: int = 1024):
    """q (B,Hq,dh), k/v_cache (B,Hkv,S,dh), pos int -> (B,Hq,dh).

    ``block_s`` keeps the reference's divisibility assert; the CUDA
    kernel splits S into its own CHUNK-sized pieces.
    """
    B, Hq, dh = q.shape
    _, Hkv, S, _ = k_cache.shape
    G = Hq // Hkv
    bs = min(block_s, S)
    assert S % bs == 0
    pos = int(pos)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, pos)
    if Hq % Hkv != 0:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if not 0 <= pos < S:
        raise ValueError(f"pos={pos} outside the cache [0, {S})")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError("q, k_cache and v_cache dtypes differ")
    if v_cache.shape != k_cache.shape:
        raise ValueError("k_cache and v_cache shapes differ")
    for t in (q, k_cache, v_cache):
        if t.stride(-1) != 1 or t.device != q.device:
            raise ValueError("decode kernel needs a contiguous last dim "
                             "and one device")
    n_split = pos // CHUNK + 1
    f32 = dict(dtype=torch.float32, device=q.device)
    part_m = torch.empty((B * Hkv, n_split, G), **f32)
    part_l = torch.empty((B * Hkv, n_split, G), **f32)
    part_acc = torch.empty((B * Hkv, n_split, G, dh), **f32)
    out = torch.empty((B, Hq, dh), dtype=q.dtype, device=q.device)
    err = _build.lib().repro_decode_attention(
        _build.dtype_code(q), q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), out.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), part_acc.data_ptr(), B, Hkv, G, dh, pos, n_split,
        q.stride(0), q.stride(1), k_cache.stride(0), k_cache.stride(1),
        k_cache.stride(2), v_cache.stride(0), v_cache.stride(1),
        v_cache.stride(2), dh ** -0.5, _build.stream_ptr(q))
    _build.check(err, "repro_decode_attention")
    _build.LAUNCHES["decode_attention"] += 1
    return out
