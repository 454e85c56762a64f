"""Recurrent temporal-mixing blocks: RG-LRU (RecurrentGemma/Griffin) and
the xLSTM cells, mLSTM (matrix memory; parallel, chunkwise and step forms)
and sLSTM (scalar memory, sequential) (twin of the reference's
``models/recurrent.py``).

The RG-LRU prefill recurrence runs the RG-LRU scan kernel (``ops.rglru``):
on a CUDA tensor the hand-written kernel, on a CPU tensor its plain
version; both walk S in order and round a*h and +b apart, so they agree
bit for bit.  The reference runs an associative scan with ``h0`` folded
into the first step instead; both compute h_t = a_t h_{t-1} + b_t, in
other orders of rounding.  The decode step stays plain torch, as the
reference's has no kernel.  Training runs ``rglru_assoc_scan``, the
reference's associative scan in PyTorch operations (the kernel has no
backward).

The xLSTM cells are plain PyTorch operations: the reference has no Pallas
kernel for them.  The fp32 upcasts, the casts back to the input dtype,
the masked ``-inf`` and the ``-1e30`` / ``-10.0`` initial stabilisers sit
where the reference has them; its ``jax.checkpoint`` and ``lax.scan``
become Python loops over chunks and steps.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.runtime.sharding import reshape

SQRT_EPS = 1e-8
RGLRU_C = 8.0


def block_diag_linear(x, w, b=None):
    """x (..., H, dh_in) @ w (H, dh_in, dh_out)."""
    y = torch.einsum("...hi,hij->...hj", x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def _rglru_coeffs(x, p, n_heads):
    """x (B,S,d_rnn) -> a (gate-modulated decay), b (gated input), fp32."""
    B, S, d = x.shape
    xh = reshape(x, (B, S, n_heads, d // n_heads))
    r = torch.sigmoid(reshape(block_diag_linear(xh, p["w_a"], p["b_a"]),
                              (B, S, d)).float())
    i = torch.sigmoid(reshape(block_diag_linear(xh, p["w_x"], p["b_x"]),
                              (B, S, d)).float())
    lam = p["lam"].float()
    # jax.nn.softplus is logaddexp(x, 0)
    log_a = -RGLRU_C * r * torch.logaddexp(lam, torch.zeros_like(lam))
    a = torch.exp(log_a)
    a2 = torch.exp(2.0 * log_a)
    b = torch.sqrt(torch.clamp(1.0 - a2, min=SQRT_EPS)) * i * x.float()
    return a, b


def rglru_scan(x, p, n_heads, h0=None):
    """RG-LRU over a sequence.  x (B, S, d_rnn); h0 (B, d_rnn) optional
    initial state.  Returns (y (B,S,d_rnn), h_last (B,d_rnn) fp32)."""
    a, b = _rglru_coeffs(x, p, n_heads)
    B, S, D = a.shape
    h0 = torch.zeros((B, D), dtype=torch.float32, device=a.device) \
        if h0 is None else h0.float().contiguous()
    # one block over the whole (S, D): the reference's divisibility
    # asserts then hold for any prompt length
    hh = ops.rglru(a.contiguous(), b.contiguous(), h0, block_s=S, block_d=D)
    return hh.to(x.dtype), hh[:, -1]


def _interleave(a, b):
    """a0 b0 a1 b1 ... along dim 1; a has as many entries as b or one
    more."""
    n = b.shape[1]
    out = torch.stack([a[:, :n], b], dim=2).flatten(1, 2)
    return torch.cat([out, a[:, n:]], dim=1) if a.shape[1] > n else out


def associative_scan(combine, elems):
    """Inclusive scan of the list ``elems`` along dim 1 under the
    associative ``combine``: ``jax.lax.associative_scan``'s recursion
    (pairs combined, the half-length scan, the even entries filled in),
    so its products round in the reference's order; log depth in S."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    odd = associative_scan(combine, combine([e[:, 0:-1:2] for e in elems],
                                            [e[:, 1::2] for e in elems]))
    if n % 2 == 0:
        even = combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def rglru_assoc_scan(x, p, n_heads, h0=None):
    """Parallel RG-LRU over a sequence by associative scan, differentiable
    (the reference's ``rglru_scan``).  x (B, S, d_rnn); h0 (B, d_rnn)
    optional, folded into the first step.  Returns (y (B,S,d_rnn),
    h_last (B,d_rnn) fp32)."""
    a, b = _rglru_coeffs(x, p, n_heads)
    if h0 is not None:
        # h_1 = a_1 h0 + b_1
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)

    def combine(c1, c2):
        (a1, b1), (a2, b2) = c1, c2
        return [a1 * a2, a2 * b1 + b2]

    _, hh = associative_scan(combine, [a, b])
    return hh.to(x.dtype), hh[:, -1]


def rglru_step(x, p, n_heads, h):
    """One decode step. x (B, d_rnn), h (B, d_rnn) -> (y, h_new)."""
    a, b = _rglru_coeffs(x[:, None], p, n_heads)
    h_new = a[:, 0] * h.float() + b[:, 0]
    return h_new.to(x.dtype), h_new


def causal_conv1d(x, w, b, state=None):
    """Depthwise causal conv.  x (B,S,d), w (W,d).  state (B,W-1,d) for
    decode.  Returns (y, new_state)."""
    W = w.shape[0]
    if state is None:
        xp = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i].to(x.dtype) for i in range(W))
    y = y + b.to(x.dtype)
    return y, xp[:, -(W - 1):]


# ---------------------------------------------------------------------------
# mLSTM (matrix memory; parallel quadratic, chunkwise and recurrent forms)
# ---------------------------------------------------------------------------

def mlstm_parallel(q, k, v, log_i, log_f):
    """q,k,v (B,H,S,dh); log_i/log_f (B,H,S) fp32. Returns h (B,H,S,dh)."""
    S, dh = q.shape[2], q.shape[3]
    F = torch.cumsum(log_f.float(), dim=-1)               # inclusive
    D = F[..., :, None] - F[..., None, :] + log_i.float()[..., None, :]
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    D = D.masked_fill(~mask, float("-inf"))
    m = torch.amax(D, dim=-1)                              # (B,H,S)
    Ds = torch.exp(D - m[..., None])
    # the reference's preferred_element_type=float32: products of the
    # input dtype summed in fp32
    scores = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) \
        * (dh ** -0.5)
    Sm = scores * Ds
    norm = torch.maximum(torch.abs(torch.sum(Sm, dim=-1)), torch.exp(-m))
    h = torch.einsum("bhst,bhtd->bhsd", Sm.to(v.dtype).float(), v.float())
    return (h / norm[..., None]).to(q.dtype)


def mlstm_step(q, k, v, log_i, log_f, state):
    """Recurrent mLSTM step (stabilized).

    q,k,v (B,H,dh); log_i/log_f (B,H); state = (C (B,H,dh,dh), n (B,H,dh),
    m (B,H)).  Returns (h (B,H,dh), new_state).
    """
    C, n, m = state
    li, lf = log_i.float(), log_f.float()
    m_new = torch.maximum(lf + m, li)
    i_p = torch.exp(li - m_new)
    f_p = torch.exp(lf + m - m_new)
    k32, v32, q32 = k.float(), v.float(), q.float()
    C_new = f_p[..., None, None] * C + i_p[..., None, None] * (
        k32[..., :, None] * v32[..., None, :])
    n_new = f_p[..., None] * n + i_p[..., None] * k32
    qs = q32 * (q.shape[-1] ** -0.5)
    num = torch.einsum("bhd,bhde->bhe", qs, C_new)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qs, n_new)),
                        torch.exp(-m_new))
    h = (num / den[..., None]).to(q.dtype)
    return h, (C_new, n_new, m_new)


def _empty_mlstm_state(B, H, dh, dv, device=None):
    return (torch.zeros((B, H, dh, dv), dtype=torch.float32, device=device),
            torch.zeros((B, H, dh), dtype=torch.float32, device=device),
            torch.full((B, H), -1e30, dtype=torch.float32, device=device))


def _chunk_update(k, v, li, lf, F, state):
    """Chunk-end state update. k,v (B,H,W,dh); li/lf/F (B,H,W)."""
    C, n, m = state
    F_tot = F[..., -1]                                     # (B,H)
    decay_s = F_tot[..., None] - F + li                    # (B,H,W)
    m_new = torch.maximum(m + F_tot, torch.amax(decay_s, dim=-1))
    carry_c = torch.exp(m + F_tot - m_new)
    w_s = torch.exp(decay_s - m_new[..., None])
    k32, v32 = k.float(), v.float()
    C_new = carry_c[..., None, None] * C + torch.einsum(
        "bhwd,bhwe->bhde", w_s[..., None] * k32, v32)
    n_new = carry_c[..., None] * n + torch.einsum("bhw,bhwd->bhd", w_s, k32)
    return C_new, n_new, m_new


def mlstm_final_state(q, k, v, log_i, log_f, state=None):
    """State after consuming the whole sequence (for prefill caches)."""
    B, H, S, dh = k.shape
    if state is None:
        state = _empty_mlstm_state(B, H, dh, v.shape[-1], k.device)
    F = torch.cumsum(log_f.float(), dim=-1)
    return _chunk_update(k, v, log_i.float(), log_f, F, state)


def mlstm_chunkwise(q, k, v, log_i, log_f, *, chunk: int, state=None):
    """Chunkwise-parallel mLSTM: O(S*chunk) intra + O(S/chunk) recurrence.

    q,k,v (B,H,S,dh); log_i/log_f (B,H,S).  Returns (h, final_state).
    Numerically consistent with mlstm_parallel / mlstm_step (stabilized).
    """
    B, H, S, dh = q.shape
    dv = v.shape[-1]
    assert S % chunk == 0
    if state is None:
        state = _empty_mlstm_state(B, H, dh, dv, q.device)
    scale = dh ** -0.5
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))
    C, n, m = state
    hs = []
    for c0 in range(0, S, chunk):
        qc, kc, vc = (t[:, :, c0:c0 + chunk] for t in (q, k, v))
        li = log_i[..., c0:c0 + chunk].float()
        lf = log_f[..., c0:c0 + chunk].float()
        F = torch.cumsum(lf, dim=-1)
        D = F[..., :, None] - F[..., None, :] + li[..., None, :]
        D = D.masked_fill(~tri, float("-inf"))
        g = F + m[..., None]                               # inter exponent
        m_t = torch.maximum(torch.amax(D, dim=-1), g)      # (B,H,W)
        Ds = torch.exp(D - m_t[..., None])
        inter_w = torch.exp(g - m_t)                       # (B,H,W)
        scores = torch.einsum("bhsd,bhtd->bhst", qc.float(),
                              kc.float()) * scale
        Sm = scores * Ds
        q32 = qc.float() * scale
        num = torch.einsum("bhst,bhtd->bhsd", Sm.to(vc.dtype).float(),
                           vc.float()) \
            + inter_w[..., None] * torch.einsum("bhsd,bhde->bhse", q32, C)
        den = torch.abs(torch.sum(Sm, dim=-1)
                        + inter_w * torch.einsum("bhsd,bhd->bhs", q32, n))
        den = torch.maximum(den, torch.exp(-m_t))
        hs.append((num / den[..., None]).to(qc.dtype))
        C, n, m = _chunk_update(kc, vc, li, lf, F, (C, n, m))
    return torch.cat(hs, dim=2), (C, n, m)


def groupnorm_heads(x, scale, n_heads, eps: float = 1e-5):
    """Per-head LayerNorm (GroupNorm with groups = heads). x (..., inner)."""
    shp = x.shape
    dh = shp[-1] // n_heads
    xh = reshape(x, shp[:-1] + (n_heads, dh)).float()
    mu = torch.mean(xh, dim=-1, keepdim=True)
    var = torch.var(xh, dim=-1, keepdim=True, unbiased=False)  # jnp.var
    y = (xh - mu) * torch.rsqrt(var + eps)
    return (reshape(y, shp) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, recurrent h->gates connections; sequential)
# ---------------------------------------------------------------------------

def slstm_seq(x, p, n_heads, state=None):
    """x (B,S,D). Block-diagonal recurrent weights per head.

    state: (c, n, h, m) each (B, D).  Returns (y (B,S,D), new_state).
    """
    B, S, D = x.shape
    dh = D // n_heads
    wx = p["w_in"].float()                    # (D, 4D) -> z,i,f,o pre-acts
    r = p["r"].float()                        # (H, dh, 4*dh) recurrent
    b = p["b"].float()                        # (4D,)
    if state is None:
        zeros = torch.zeros((B, D), dtype=torch.float32, device=x.device)
        state = (zeros, zeros, zeros, zeros - 10.0)
    pre_x = torch.einsum("bsd,de->bse", x.float(), wx) + b
    c, n, h, m = state
    ys = []
    for t in range(S):
        # the per-head product laid out head-major, (B, H*4*dh), before
        # the split into z, i, f, o: the reference's layout, kept as is
        pre_h = torch.einsum("bhi,hij->bhj", reshape(h, (B, n_heads, dh)),
                             r).reshape(B, 4 * D)
        z_p, i_p, f_p, o_p = torch.split(pre_x[:, t] + pre_h, D, dim=-1)
        z = torch.tanh(z_p)
        o = torch.sigmoid(o_p)
        m_new = torch.maximum(f_p + m, i_p)
        i_g = torch.exp(i_p - m_new)
        f_g = torch.exp(f_p + m - m_new)
        c = f_g * c + i_g * z
        n = f_g * n + i_g
        h = o * c / torch.clamp(n, min=1e-6)
        m = m_new
        ys.append(h)
    return torch.stack(ys, dim=1).to(x.dtype), (c, n, h, m)
