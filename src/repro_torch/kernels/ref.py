"""Plain PyTorch versions of every kernel (twins of the reference's
``kernels/ref.py``).

They are the allclose ground truth for the CUDA kernels on the card, and
what a kernel wrapper runs when it is handed a tensor on the CPU.  They
repeat the kernels' arithmetic (fp32 accumulation, ``p`` cast to ``v``'s
dtype before the PV product) and are no yardstick of speed.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def gemm_ref(a, b, out_dtype=None):
    out = torch.matmul(a.float(), b.float())
    return out.to(out_dtype or a.dtype)


def gemm_partial_ref(a, b, acc, k_begin: int, k_end: int, bk: int):
    a_sl = a[:, k_begin * bk: k_end * bk].float()
    b_sl = b[k_begin * bk: k_end * bk].float()
    return acc + a_sl @ b_sl


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, softcap=None):
    """q (B,Hq,S,dqk), k (B,Hkv,Skv,dqk), v (B,Hkv,Skv,dv) -> (B,Hq,S,dv);
    the scale is dqk ** -0.5 (MLA's v head dim differs from its key's);
    query i sits at position p = ``q_offset`` + i; causal keeps the keys
    k <= p, and ``window`` > 0 those with p - window < k <= p;
    ``softcap`` c maps each scaled score s to c * tanh(s / c) before the
    mask."""
    B, Hq, S, dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (dh ** -0.5)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        qpos = q_offset + torch.arange(S, device=q.device)[:, None]
        kpos = torch.arange(Skv, device=q.device)[None, :]
        mask = kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, pos: int):
    """q (B,Hq,dh), k/v (B,Hkv,S,dh), pos int."""
    B, Hq, dh = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    k = k_cache.repeat_interleave(G, dim=1)
    v = v_cache.repeat_interleave(G, dim=1)
    s = torch.einsum("bhd,bhsd->bhs", q.float(), k.float()) * (dh ** -0.5)
    live = torch.arange(S, device=q.device)[None, None] <= pos
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhs,bhsd->bhd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def rglru_scan_ref(a, b, h0):
    """Sequential version of h_t = a_t h_{t-1} + b_t; a, b (B,S,D),
    h0 (B,D) -> (B,S,D)."""
    h = h0
    ys = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys.append(h)
    return torch.stack(ys, dim=1)
