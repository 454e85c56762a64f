"""Shared model components: norms, RoPE, initialiser, runtime config
(twin of the reference's ``models/common.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Numerics knobs.  The reference's sharding, remat and cost-probe
    knobs have no counterpart in the eager single-card port."""
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    flash_block_q: int = 512
    flash_block_kv: int = 512


DEFAULT_RC = RuntimeConfig()
CPU_RC = RuntimeConfig(compute_dtype=torch.float32)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x, scale=None, eps: float = 1e-6):
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * (1.0 + scale.float())
    return y.to(dtype)


def layernorm(x, scale=None, bias=None, eps: float = 1e-5):
    dtype = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    xc = x32 - mu
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def apply_norm(kind: str, x, params: Optional[dict]):
    if kind == "rmsnorm":
        return rmsnorm(x, params.get("scale") if params else None)
    if kind == "layernorm":
        return layernorm(x, params.get("scale") if params else None,
                         params.get("bias") if params else None)
    if kind == "layernorm_nonparam":
        return layernorm(x, None, None)
    raise ValueError(f"unknown norm {kind}")


def norm_params(kind: str, d: int, dtype, device) -> dict:
    if kind == "rmsnorm":
        return {"scale": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    return {}  # non-parametric


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_cos_sin(positions, dim: int, theta: float):
    """positions (...,) -> cos/sin (..., dim/2), fp32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., S, H, D); cos/sin broadcastable (..., S, 1, D/2)."""
    dtype = x.dtype
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, shape, dtype, device,
               scale: float = 0.02):
    """scale * truncated normal on [-2, 2], drawn in fp32 (the reference's
    ``dense_init``; torch's generator gives other numbers than
    ``jax.random`` from the same seed) and cast to ``dtype``.  A stacked
    leaf (3 or more dims) is drawn one 2-D slice at a time into its
    ``dtype`` buffer, so its fp32 draw is never whole: the routed
    experts' ``w1`` of DeepSeek-V2-Lite is 19.9 GB in fp32."""
    out = torch.empty(shape, dtype=dtype, device=device)
    _fill_trunc_normal(out, generator, scale)
    return out


def _fill_trunc_normal(out, generator, scale: float) -> None:
    """Fill ``out`` in place, one 2-D slice of fp32 draws at a time."""
    if out.dim() >= 3:
        for sl in out:
            _fill_trunc_normal(sl, generator, scale)
        return
    w = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    out.copy_(w.mul_(scale))
