"""GQA, local and MLA attention for the dense, hybrid, ``moe`` and
``mla_moe`` families (twin of the reference's ``models/attention.py``).

In the reference these are jnp functions and the Pallas kernels are
drop-in replacements nobody calls.  Here the swap is made: on a CUDA
tensor ``flash_attention`` and ``local_attention`` run the flash kernel
(the latter with a window; both with the reference's ``q_offset``, and
``flash_attention`` with its ``softcap``) and ``decode_attention`` the
flash-decoding kernel; on a CPU tensor they run the kernels' plain
versions.  MLA's prefill runs the flash kernel with a value head dim
(128) below the key's (192); its weight-absorbed decode is PyTorch
operations, as the reference's is jnp outside any Pallas kernel.

Training differentiates the model, and the kernels have no backward: its
forward runs ``blocked_attention`` and ``blocked_local_attention``,
twins of the reference's jnp ``flash_attention`` and ``local_attention``
in PyTorch operations (the same blocks, masks, online softmax and fp32
products), each query block under a checkpoint as there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops
from repro_torch.runtime import sharding, trace
from repro_torch.runtime.sharding import reshape, seq_matmul
from repro_torch.models.common import (apply_rope, checkpoint, rmsnorm,
                                       rope_cos_sin)

NEG_INF = -1e30


def _split_heads(x, n_heads, dh):
    return reshape(x, x.shape[:-1] + (n_heads, dh))


def flash_attention(q, k, v, *, causal: bool = True, q_offset=0,
                    block_q: int = 512, block_kv: int = 512, softcap=None):
    """q (B,Sq,Hq,Dqk), k (B,Skv,Hkv,Dqk), v (B,Skv,Hkv,Dv) ->
    (B,Sq,Hq,Dv), scaled by Dqk ** -0.5.

    ``q_offset`` is the absolute position of q[0] (for chunked prefill);
    ``softcap`` c maps each scaled score s to c * tanh(s / c) before the
    causal mask.  While the tracer is on, the call is a span
    ``kernel.flash_attention``.
    """
    with trace.span("kernel.flash_attention", tokens=q.shape[1]) \
            if trace.ON else trace.NULL:
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                block_q=block_q, block_kv=block_kv,
                                q_offset=q_offset, softcap=softcap)
    return o.transpose(1, 2)


def local_attention(q, k, v, *, window: int, q_offset=0, block_q: int = 512):
    """Banded causal attention: each query attends the previous ``window``
    keys (inclusive of self).  q (B,Sq,Hq,Dh), k/v (B,Skv,Hkv,Dh) with
    Skv == q_offset + Sq (the usual prefill layout) -> (B,Sq,Hq,Dh).
    """
    Sq, Skv = q.shape[1], k.shape[1]
    bq = min(block_q, Sq)
    assert Sq % bq == 0
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True, block_q=block_q,
                            block_kv=Skv, window=window, q_offset=q_offset)
    return o.transpose(1, 2)


def _on_local_shards(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` on each rank's local shards of the DTensors
    q, k, v (B, S, H, d), placed as the flash kernel's are
    (``sharding.attention_local``): the blocked loops run collective-free
    and without DTensor's dispatch per operation."""
    def local(ql, kl, vl):
        return fn(ql.transpose(1, 2), kl.transpose(1, 2),
                  vl.transpose(1, 2), **kw).transpose(1, 2)
    return sharding.attention_local(local, q.transpose(1, 2),
                                    k.transpose(1, 2),
                                    v.transpose(1, 2)).transpose(1, 2)


def blocked_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                      block_q: int = 512, block_kv: int = 512, softcap=None):
    """Blocked online-softmax attention, differentiable (the reference's
    jnp ``flash_attention``).  q (B,Sq,Hq,Dqk), k (B,Skv,Hkv,Dqk), v
    (B,Skv,Hkv,Dv) -> (B,Sq,Hq,Dv), scaled by Dqk ** -0.5.

    KV blocks are visited in order with masking (masked blocks are not
    skipped); products of the input dtype are summed in fp32, and the
    probabilities are cast to v's dtype before the PV product.
    ``q_offset`` is the absolute position of q[0].  Each query block runs
    under a checkpoint, so its backward recomputes the KV loop instead of
    keeping score blocks.  DTensors run on their local shards.
    """
    if isinstance(q, DTensor):
        return _on_local_shards(blocked_attention, q, k, v, causal=causal,
                                q_offset=q_offset, block_q=block_q,
                                block_kv=block_kv, softcap=softcap)
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    bq, bkv = min(block_q, Sq), min(block_kv, Skv)
    assert Sq % bq == 0 and Skv % bkv == 0, (Sq, bq, Skv, bkv)
    scale = Dh ** -0.5

    def q_block(qi, i, k, v):
        q_pos = q_offset + i * bq + torch.arange(bq, device=q.device)
        qf = qi.float()
        m = torch.full((B, Hq, bq), NEG_INF, device=q.device)
        l = torch.zeros((B, Hq, bq), device=q.device)
        acc = torch.zeros((B, Hq, bq, v.shape[-1]), device=q.device)
        for j in range(Skv // bkv):
            kj, vj = k[:, j * bkv:(j + 1) * bkv], v[:, j * bkv:(j + 1) * bkv]
            if G > 1:
                kj = kj.repeat_interleave(G, dim=2)
                vj = vj.repeat_interleave(G, dim=2)
            s = torch.einsum("bqhd,bkhd->bhqk", qf, kj.float()) * scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            if causal:
                k_pos = j * bkv + torch.arange(bkv, device=q.device)
                mask = q_pos[:, None] >= k_pos[None, :]
                s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            # a block masked whole leaves the running max at NEG_INF, where
            # exp(s - m) would be 1: zero the masked entries
            p = torch.exp(s - m_new[..., None]) * (s > NEG_INF * 0.5)
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bhqk,bkhd->bhqd", p.to(vj.dtype).float(),
                              vj.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        return acc / torch.clamp(l, min=1e-30)[..., None]   # (B,Hq,bq,Dv)

    outs = [checkpoint(q_block, q[:, i * bq:(i + 1) * bq], i, k, v)
            for i in range(Sq // bq)]
    return torch.cat(outs, dim=2).transpose(1, 2).to(q.dtype)


def blocked_local_attention(q, k, v, *, window: int, q_offset: int = 0,
                            block_q: int = 512):
    """Banded causal attention, differentiable (the reference's jnp
    ``local_attention``): each query attends the previous ``window`` keys
    (inclusive of self).  q (B,Sq,Hq,Dh), k/v (B,Skv,Hkv,Dh) with Skv ==
    q_offset + Sq -> (B,Sq,Hq,Dh).  Keys are padded on the left by
    ``window`` so each query block takes a span of window + block keys;
    each block runs under a checkpoint.  DTensors run on their local
    shards.
    """
    if isinstance(q, DTensor):
        return _on_local_shards(blocked_local_attention, q, k, v,
                                window=window, q_offset=q_offset,
                                block_q=block_q)
    B, Sq, Hq, Dh = q.shape
    G = Hq // k.shape[2]
    bq = min(block_q, Sq)
    assert Sq % bq == 0
    span = window + bq
    scale = Dh ** -0.5
    kp = F.pad(k, (0, 0, 0, 0, window, 0))
    vp = F.pad(v, (0, 0, 0, 0, window, 0))
    qpos = torch.arange(bq, device=q.device)[:, None]
    kpos = torch.arange(span, device=q.device)[None, :] - window

    def q_block(qi, i, kp, vp):
        start = q_offset + i * bq
        ks, vs = kp[:, start:start + span], vp[:, start:start + span]
        if G > 1:
            ks = ks.repeat_interleave(G, dim=2)
            vs = vs.repeat_interleave(G, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qi.float(), ks.float()) * scale
        valid = (kpos <= qpos) & (kpos > qpos - window) & (kpos + start >= 0)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bhqd", p.to(vs.dtype).float(),
                            vs.float())

    outs = [checkpoint(q_block, q[:, i * bq:(i + 1) * bq], i, kp, vp)
            for i in range(Sq // bq)]
    return torch.cat(outs, dim=2).transpose(1, 2).to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos, pos_top=None):
    """q (B,Hq,Dh); k/v_cache (B,S,Hkv,Dh); pos the current position (a
    host int or a 0-d int64 tensor on q's device; the kernel's plan is
    ``pos_top``'s, default ``pos``).  Positions > pos are masked."""
    return ops.decode_attention(q, k_cache.transpose(1, 2),
                                v_cache.transpose(1, 2), pos,
                                pos_top=pos_top)


def positions_at(pos, B: int, device):
    """(B, 1) positions, all ``pos`` (a host int or a 0-d tensor, whose
    value is read where it is used)."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1, 1).expand(B, 1)
    return torch.full((B, 1), pos, device=device)


def cache_update(cache, new, pos, use_dus: bool = False):
    """Write ``new`` (B, Hkv, Dh) into cache (B, S, Hkv, Dh) at ``pos``
    (any trailing dims: MLA's (B, lora) into (B, S, lora)), in place;
    returns ``cache``.  ``pos`` is a host int or a 0-d int64 tensor.

    Default: the reference's one-hot select over the whole cache, which a
    cache sharded on S takes shard by shard (each touches only its
    S-slice) at the cost of a full cache read and write.  ``use_dus``
    writes the one position (the reference's dynamic-update-slice; at a
    device position, ``index_copy_``).  Both leave the same values.
    """
    new = new[:, None].to(cache.dtype)
    if use_dus:
        if isinstance(pos, torch.Tensor):
            return cache.index_copy_(1, pos.reshape(1), new)
        cache[:, pos:pos + 1] = new
        return cache
    hit = torch.arange(cache.shape[1], device=new.device) == pos
    hit = hit.reshape((1, -1) + (1,) * (cache.dim() - 2))
    cache.copy_(torch.where(hit, new, cache))
    return cache


def gqa_project_qkv(x, p, cfg, positions):
    """x (B,S,D) -> q (B,S,Hq,Dh), k,v (B,S,Hkv,Dh), RoPE applied."""
    dh = cfg.dh
    q = seq_matmul(x, p["wq"].to(x.dtype))
    k = seq_matmul(x, p["wk"].to(x.dtype))
    v = seq_matmul(x, p["wv"].to(x.dtype))
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

def _mla_rope(cfg, positions):
    """cos/sin (B,S,1,dr/2) of the MLA rope part."""
    cos, sin = rope_cos_sin(positions, cfg.mla.qk_rope_dim, cfg.rope_theta)
    return cos[:, :, None, :], sin[:, :, None, :]


def mla_prefill_qkv(x, p, cfg, positions):
    """x (B,S,D) -> q (B,S,H,dn+dr), decompressed k (B,S,H,dn+dr),
    v (B,S,H,dv), and the compressed cache entries c (B,S,lora) and
    k_rope (B,S,dr).  The one rope key of a position is broadcast to
    every head."""
    m, H = cfg.mla, cfg.n_heads
    ckv = seq_matmul(x, p["w_dkv"].to(x.dtype))
    c, kr = torch.split(ckv, [m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    c = rmsnorm(c, p["c_norm"])
    cos, sin = _mla_rope(cfg, positions)
    kr = apply_rope(kr[:, :, None, :], cos, sin)[:, :, 0]
    q = _split_heads(seq_matmul(x, p["w_q"].to(x.dtype)), H,
                     m.qk_nope_dim + m.qk_rope_dim)
    qn, qr = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    qr = apply_rope(qr, cos, sin)
    k_nope = torch.einsum("bsl,lhn->bshn", c, reshape(
        p["w_uk"].to(x.dtype), (m.kv_lora_rank, H, m.qk_nope_dim)))
    v = torch.einsum("bsl,lhv->bshv", c, reshape(
        p["w_uv"].to(x.dtype), (m.kv_lora_rank, H, m.v_head_dim)))
    q_full = torch.cat([qn, qr], dim=-1)
    k_full = torch.cat([k_nope, kr[:, :, None, :].expand(
        qn.shape[:-1] + (m.qk_rope_dim,))], dim=-1)
    return q_full, k_full, v, c, kr


def mla_decode(x, p, cfg, c_cache, kr_cache, pos):
    """Weight-absorbed MLA decode over the compressed cache.

    x (B,D); c_cache (B,T,lora) and kr_cache (B,T,dr) are one layer's
    cache, written in place at ``pos`` (a host int or a 0-d int64
    tensor) by the reference's one-hot select.  Returns out (B,D).  The scale is (dn + dr) ** -0.5, the
    decompressed key's.
    """
    m, H = cfg.mla, cfg.n_heads
    B = x.shape[0]
    ckv = torch.matmul(x, p["w_dkv"].to(x.dtype))
    c, kr = torch.split(ckv, [m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    c = rmsnorm(c, p["c_norm"])
    cos, sin = _mla_rope(cfg, positions_at(pos, B, x.device))
    kr = apply_rope(kr[:, None, None, :], cos, sin)[:, 0, 0]
    q = reshape(torch.matmul(x, p["w_q"].to(x.dtype)),
                (B, H, m.qk_nope_dim + m.qk_rope_dim))
    qn, qr = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    qr = apply_rope(qr[:, None], cos, sin)[:, 0]
    # absorb W_uk into q: scores_nope = (q_n W_uk^T) . c
    w_uk = reshape(p["w_uk"].to(x.dtype), (m.kv_lora_rank, H, m.qk_nope_dim))
    q_abs = torch.einsum("bhn,lhn->bhl", qn, w_uk)
    cache_update(c_cache, c, pos)
    cache_update(kr_cache, kr, pos)
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    # fp32 products, as preferred_element_type=float32 asks
    s = (torch.einsum("bhl,bsl->bhs", q_abs.float(), c_cache.float())
         + torch.einsum("bhr,bsr->bhs", qr.float(), kr_cache.float())) * scale
    live = torch.arange(c_cache.shape[1], device=x.device) <= pos
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    pr = torch.softmax(s, dim=-1)
    o_c = torch.einsum("bhs,bsl->bhl", pr.to(c_cache.dtype).float(),
                       c_cache.float())
    w_uv = reshape(p["w_uv"].to(x.dtype), (m.kv_lora_rank, H, m.v_head_dim))
    o = torch.einsum("bhl,lhv->bhv", o_c.to(x.dtype), w_uv)
    return torch.einsum("bhv,hvd->bd", o, reshape(
        p["w_o"].to(x.dtype), (H, m.v_head_dim, -1)))
