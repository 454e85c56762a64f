"""RG-LRU recurrent block pieces (twin of the RG-LRU half of the
reference's ``models/recurrent.py``; the xLSTM cells arrive with their
family).

The prefill recurrence runs the RG-LRU scan kernel (``ops.rglru``): on a
CUDA tensor the hand-written kernel, on a CPU tensor its plain version;
both walk S in order and round a*h and +b apart, so they agree bit for
bit.  The reference runs an associative scan with ``h0`` folded into the
first step instead; both compute h_t = a_t h_{t-1} + b_t, in other orders
of rounding.  The decode step stays plain torch, as the reference's has no
kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

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
    xh = x.reshape(B, S, n_heads, d // n_heads)
    r = torch.sigmoid(block_diag_linear(xh, p["w_a"], p["b_a"])
                      .reshape(B, S, d).float())
    i = torch.sigmoid(block_diag_linear(xh, p["w_x"], p["b_x"])
                      .reshape(B, S, d).float())
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
