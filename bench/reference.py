"""Plain PyTorch reference of the two served families, in float32; it
imports nothing of the program.  On the card its products run in TF32
(10-bit mantissas, float32 sums): eight times finer than the bf16
program's rounding, and some seven times faster than float32 products,
so that the check of some hundreds of served tokens stays shorter than
the window.

It follows the configuration file (the configuration as it is run) and
takes the benchmark's weights: the tree ``bench.weights.make_params``
made, in the parameter layout the file writes out (weights (in, out),
layers stacked on a leading dim).  Each layer's weights are cast to
float32 as the layer runs, so the reference fits beside the bf16 weights.

One call runs whole sequences: a request's prompt, then the token fed at
each decode step (the prompt's last token again, then every served token
but the last), and returns the logits at the decode positions.  A served
model's prefill and decode through its cache compute the same function
of those tokens, except where the configuration routes prompt tokens
with an expert capacity (``moe_capacity_factor``): the first
``prompt_len`` tokens of a row are routed with the capacity of a
``prompt_len``-token prefill, and each later token alone, with none.

``quant=True`` is the lower-precision control: every projection's input
and weight rounded to float8 e4m3 (per row and per output column scales),
the product accumulated in float32, as an fp8 GEMM would.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

_E4M3_MAX = 448.0


def fake_fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim``'s complement (the absmax along ``dim`` maps to 448)."""
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / _E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class _Ops:
    def __init__(self, quant: bool):
        self.quant = quant

    def mm(self, x, w):
        """x (..., in) @ w (in, out), both float32."""
        if self.quant:
            x, w = fake_fp8(x, -1), fake_fp8(w, 0)
        return x @ w


def rmsnorm(x, scale, eps):
    y = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return y * (1.0 + scale.float())


def rope(x, positions, theta: float):
    """x (B, T, H, D): RoPE on the two halves of D (D/2 frequencies)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = positions.float()[:, None] * inv                    # (T, D/2)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, scale: float, block: int = 256):
    """q (B,T,Hq,dqk), k (B,T,Hkv,dqk), v (B,T,Hkv,dv); query head h reads
    KV head h // (Hq / Hkv).  Softmax over keys at or before the query's
    position, in blocks of query rows."""
    B, T, Hq, _ = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    kt = k.permute(0, 2, 3, 1)                       # (B,Hkv,dqk,T)
    vt = v.permute(0, 2, 1, 3)                       # (B,Hkv,T,dv)
    out = torch.empty(B, T, Hq, v.shape[-1], dtype=q.dtype, device=q.device)
    kpos = torch.arange(T, device=q.device)
    for s in range(0, T, block):
        e = min(T, s + block)
        qb = q[:, s:e].reshape(B, e - s, Hkv, G, -1).permute(0, 2, 3, 1, 4)
        sc = torch.matmul(qb, kt[:, :, None]) * scale  # (B,Hkv,G,b,T)
        live = kpos[None, :] <= torch.arange(s, e, device=q.device)[:, None]
        sc = sc.masked_fill(~live, float("-inf"))
        o = torch.matmul(torch.softmax(sc, dim=-1), vt[:, :, None])
        out[:, s:e] = o.permute(0, 3, 1, 2, 4).reshape(B, e - s, Hq, -1)
    return out


def _f32(params, *path, i=None):
    node = params
    for key in path:
        node = node[key]
    return (node if i is None else node[i]).float()


def moe_capacity(n_tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    c = int(math.ceil(n_tokens * top_k * cf / n_experts))
    return max(4, -(-c // 4) * 4)


def _moe(ops, x, p, i, conf, prompt_len: int):
    """The expert layer on x (B, T, d): softmax router, top-k (ties to the
    lower expert), gates renormalised; tokens before ``prompt_len`` keep a
    choice only while its expert has fewer than the capacity's earlier
    choices in (token, choice) order; the shared experts on every token."""
    B, T, d = x.shape
    E, K = conf["n_routed_experts"], conf["num_experts_per_tok"]
    probs = torch.softmax(ops.mm(x, _f32(p, "router", i=i)), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = vals[..., :K], idx[..., :K]                 # (B,T,K)
    if conf["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    keep = torch.ones_like(eidx, dtype=torch.bool)
    cf = conf.get("moe_capacity_factor")
    if cf is not None and prompt_len > 0:
        cap = moe_capacity(prompt_len, K, E, cf)
        flat = eidx[:, :prompt_len].reshape(B, prompt_len * K)
        rank = torch.cumsum(F.one_hot(flat, E), dim=1).gather(
            2, flat[..., None])[..., 0] - 1
        keep[:, :prompt_len] = (rank < cap).reshape(B, prompt_len, K)
    y = torch.zeros_like(x)
    xf = x.reshape(B * T, d)
    w1, w3, w2 = (_f32(p, w, i=i) for w in ("w1", "w3", "w2"))
    for e in range(E):
        hit = (eidx == e) & keep                                  # (B,T,K)
        rows = hit.any(-1).reshape(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        g = (gates * hit).sum(-1).reshape(-1)[rows]
        xe = xf[rows]
        ye = ops.mm(F.silu(ops.mm(xe, w1[e])) * ops.mm(xe, w3[e]), w2[e])
        y.view(B * T, d).index_add_(0, rows, ye * g[:, None])
    s = p["shared"]
    x1 = ops.mm(x, _f32(s, "w1", i=i))
    x3 = ops.mm(x, _f32(s, "w3", i=i))
    return y + ops.mm(F.silu(x1) * x3, _f32(s, "w2", i=i))


def _dense_layer(ops, h, params, i, conf, pos):
    p = params["blocks"]
    eps = conf["rms_norm_eps"]
    hq, hkv = conf["num_attention_heads"], conf["num_key_value_heads"]
    d = conf["hidden_size"]
    dh = d // hq
    B, T, _ = h.shape
    a = p["attn"]
    x = rmsnorm(h, a["ln"]["scale"][i], eps)
    q = ops.mm(x, _f32(a, "wq", i=i)).view(B, T, hq, dh)
    k = ops.mm(x, _f32(a, "wk", i=i)).view(B, T, hkv, dh)
    v = ops.mm(x, _f32(a, "wv", i=i)).view(B, T, hkv, dh)
    th = conf["rope_theta"]
    o = causal_attention(rope(q, pos, th), rope(k, pos, th), v, dh ** -0.5)
    h = h + ops.mm(o.reshape(B, T, hq * dh), _f32(a, "wo", i=i))
    m = p["mlp"]
    x = rmsnorm(h, m["ln"]["scale"][i], eps)
    gate = F.silu(ops.mm(x, _f32(m, "w1", i=i))) * ops.mm(x, _f32(m, "w3", i=i))
    return h + ops.mm(gate, _f32(m, "w2", i=i))


def _mla_moe_layer(ops, h, params, i, conf, pos, prompt_len):
    p = params["blocks"]
    eps = conf["rms_norm_eps"]
    H, lora = conf["num_attention_heads"], conf["kv_lora_rank"]
    dn, dr = conf["qk_nope_head_dim"], conf["qk_rope_head_dim"]
    dv = conf["v_head_dim"]
    B, T, _ = h.shape
    a = p["attn"]
    x = rmsnorm(h, a["ln"]["scale"][i], eps)
    ckv = ops.mm(x, _f32(a, "w_dkv", i=i))
    c = rmsnorm(ckv[..., :lora], a["c_norm"][i], eps)
    kr = rope(ckv[..., None, lora:], pos, conf["rope_theta"])  # (B,T,1,dr)
    q = ops.mm(x, _f32(a, "w_q", i=i)).view(B, T, H, dn + dr)
    qr = rope(q[..., dn:], pos, conf["rope_theta"])
    k_nope = ops.mm(c, _f32(a, "w_uk", i=i)).view(B, T, H, dn)
    v = ops.mm(c, _f32(a, "w_uv", i=i)).view(B, T, H, dv)
    qf = torch.cat([q[..., :dn], qr], dim=-1)
    kf = torch.cat([k_nope, kr.expand(B, T, H, dr)], dim=-1)
    o = causal_attention(qf, kf, v, (dn + dr) ** -0.5)
    h = h + ops.mm(o.reshape(B, T, H * dv), _f32(a, "w_o", i=i))
    x = rmsnorm(h, p["moe"]["ln"]["scale"][i], eps)
    return h + _moe(ops, x, p["moe"], i, conf, prompt_len)


def logits_at(conf: dict, params: dict, tokens: torch.Tensor,
              prompt_len: int, quant: bool = False) -> torch.Tensor:
    """tokens (B, T) of B rows of one shape, the first ``prompt_len`` of
    each its prompt -> float32 logits (B, T - prompt_len, V) at positions
    prompt_len .. T - 1."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            return _logits_at(conf, params, tokens, prompt_len, _Ops(quant))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _logits_at(conf, params, tokens, prompt_len, ops):
    kind = conf["reference"]
    tokens = tokens.to(params["embed"].device).long()
    T = tokens.shape[1]
    pos = torch.arange(T, device=tokens.device)
    h = params["embed"][tokens].float()
    for i in range(conf["num_hidden_layers"]):
        if kind == "dense":
            h = _dense_layer(ops, h, params, i, conf, pos)
        elif kind == "mla_moe":
            h = _mla_moe_layer(ops, h, params, i, conf, pos, prompt_len)
        else:
            raise ValueError(f"no reference for {kind!r}")
    x = rmsnorm(h[:, prompt_len:], params["out_norm"]["scale"],
                conf["rms_norm_eps"])
    return ops.mm(x, params["lm_head"].float())


def fed_tokens(prompt, generated) -> list:
    """What a served request fed the model: its prompt, the prompt's last
    token again (the first decode step), then each served token but the
    last."""
    prompt = [int(t) for t in prompt]
    return prompt + [prompt[-1]] + [int(t) for t in generated[:-1]]


def widest_gap(logits: torch.Tensor, served: torch.Tensor,
               picked: Optional[torch.Tensor] = None) -> float:
    """The widest gap by which the logit of ``served`` (or, for the
    control, of each row's ``picked`` token) lies below the row's best,
    in the float32 reference's ``logits`` (N, V)."""
    tok = served if picked is None else picked
    best = logits.max(dim=-1).values
    return float((best - logits.gather(-1, tok[:, None])[:, 0]).max())
