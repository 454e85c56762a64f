"""GQA and local attention for the dense and hybrid families (twin of
the GQA and local subset of the reference's ``models/attention.py``).

In the reference these are jnp functions and the Pallas kernels are
drop-in replacements nobody calls.  Here the swap is made: on a CUDA
tensor ``flash_attention`` and ``local_attention`` run the flash kernel
(the latter with a window) and ``decode_attention`` the flash-decoding
kernel; on a CPU tensor they run the kernels' plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, rope_cos_sin

NEG_INF = -1e30


def _split_heads(x, n_heads, dh):
    return x.reshape(x.shape[:-1] + (n_heads, dh))


def flash_attention(q, k, v, *, causal: bool = True, q_offset=0,
                    block_q: int = 512, block_kv: int = 512, softcap=None):
    """q (B,Sq,Hq,Dh), k/v (B,Skv,Hkv,Dh) -> (B,Sq,Hq,Dh).

    The dense family's prefill never passes ``q_offset`` or ``softcap``;
    the kernel has neither, so both raise until a family needs them.
    """
    if q_offset != 0 or softcap is not None:
        raise NotImplementedError("q_offset and softcap are not ported "
                                  "(no dense-family caller)")
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal,
                            block_q=block_q, block_kv=block_kv)
    return o.transpose(1, 2)


def local_attention(q, k, v, *, window: int, q_offset=0, block_q: int = 512):
    """Banded causal attention: each query attends the previous ``window``
    keys (inclusive of self).  q (B,Sq,Hq,Dh), k/v (B,Skv,Hkv,Dh) with
    Skv == Sq -> (B,Sq,Hq,Dh).

    The hybrid family's prefill never passes ``q_offset``; the kernel has
    none, so it raises until a caller needs it.
    """
    if q_offset != 0:
        raise NotImplementedError("q_offset is not ported (no caller)")
    Sq = q.shape[1]
    bq = min(block_q, Sq)
    assert Sq % bq == 0
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True, block_q=block_q,
                            block_kv=block_q, window=window)
    return o.transpose(1, 2)


def decode_attention(q, k_cache, v_cache, pos: int):
    """q (B,Hq,Dh); k/v_cache (B,S,Hkv,Dh); pos int current position.
    Positions > pos are masked."""
    return ops.decode_attention(q, k_cache.transpose(1, 2),
                                v_cache.transpose(1, 2), pos)


def cache_update(cache, new, pos: int):
    """Write ``new`` (B, Hkv, Dh) into cache (B, S, Hkv, Dh) at ``pos``.

    An in-place write of one position; it equals the reference's one-hot
    select (and its DUS option), which returns a new cache with only
    position ``pos`` replaced.  Returns ``cache``.
    """
    cache[:, pos] = new.to(cache.dtype)
    return cache


def gqa_project_qkv(x, p, cfg, positions):
    """x (B,S,D) -> q (B,S,Hq,Dh), k,v (B,S,Hkv,Dh), RoPE applied."""
    dh = cfg.dh
    q = torch.matmul(x, p["wq"].to(x.dtype))
    k = torch.matmul(x, p["wk"].to(x.dtype))
    v = torch.matmul(x, p["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = _split_heads(q, cfg.n_heads, dh)
    k = _split_heads(k, cfg.n_kv_heads, dh)
    v = _split_heads(v, cfg.n_kv_heads, dh)
    cos, sin = rope_cos_sin(positions, dh, cfg.rope_theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v
