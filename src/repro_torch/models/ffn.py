"""Gated MLPs (twin of the dense part of the reference's ``models/ffn.py``).

The three products stay ``torch.matmul``: the reference leaves them to
XLA, and no Pallas kernel covers them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _glu(x, p, act):
    h = torch.matmul(x, p["w1"].to(x.dtype))
    g = torch.matmul(x, p["w3"].to(x.dtype))
    return torch.matmul(act(h) * g, p["w2"].to(x.dtype))


def swiglu(x, p):
    """x (..., D) with params w1,w3 (D,F), w2 (F,D)."""
    return _glu(x, p, F.silu)


def gelu(x):
    """``jax.nn.gelu``, which defaults to the tanh form."""
    return F.gelu(x, approximate="tanh")


def geglu(x, p):
    """Gated-GeLU MLP (RecurrentGemma/Gemma style)."""
    return _glu(x, p, gelu)
