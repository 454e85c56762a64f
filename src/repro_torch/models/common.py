"""Shared model components: norms, RoPE, initialiser, runtime config,
rematerialisation and the cross-entropy losses (twin of the reference's
``models/common.py``)."""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Numerics, memory and sharding knobs (the reference's fields and
    defaults).

    ``remat_policy``: ``"none"``, ``"full"`` (a layer's backward
    recomputes its forward) or ``"dots"`` (it keeps the matrix products'
    outputs and recomputes the rest); ``remat_groups`` G > 1, when it
    divides the layer count L, also checkpoints each of G groups of L / G
    layers.  ``sequence_parallel`` shards the residual stream's S over
    'model' and ``logical_axes`` turns the sharding constraints on
    (``runtime.sharding``; both act only inside ``axis_rules``).
    ``cost_probe`` is kept so that configs carry over: the reference
    unrolls its scans for exact HLO counts, and eager PyTorch has no scan
    to unroll.  ``dus_cache_update`` writes the decode cache in place at
    ``pos`` (the reference's dynamic-update-slice) instead of its one-hot
    select over the whole cache; ``pad_attn_heads`` pads each KV group's
    query heads so that the query heads are a multiple of it (exact: the
    padded heads are dropped before the output projection).
    """
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat_policy: str = "none"          # none | full | dots
    remat_groups: int = 0               # >1: double remat over G groups
    sequence_parallel: bool = False     # shard residual-stream S over 'model'
    flash_block_q: int = 512
    flash_block_kv: int = 512
    z_loss: float = 1e-4
    logical_axes: bool = True           # emit sharding constraints
    cost_probe: bool = False            # nothing to unroll in eager PyTorch
    dus_cache_update: bool = False      # decode cache write in place
    pad_attn_heads: int = 0             # pad Q heads to this multiple for TP


DEFAULT_RC = RuntimeConfig()
CPU_RC = RuntimeConfig(compute_dtype=torch.float32)

# the reference's checkpoint_dots_with_no_batch_dims: the outputs of
# products without batch dims (every weight product reaches aten.mm;
# attention's batched einsums reach aten.bmm and are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def checkpoint(fn, *args, **kwargs):
    """``fn(*args)`` whose backward recomputes its forward
    (``jax.checkpoint``): non-reentrant, so it nests and takes any
    arguments and outputs."""
    return ckpt.checkpoint(fn, *args, use_reentrant=False, **kwargs)


def remat_wrap(fn, rc: RuntimeConfig):
    """``fn`` under ``rc.remat_policy``'s checkpoint (``"none"``: as is)."""
    if rc.remat_policy == "none":
        return fn
    if rc.remat_policy == "dots":
        ctx = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                _dots_policy)
        return functools.partial(checkpoint, fn, context_fn=ctx)
    return functools.partial(checkpoint, fn)


class _LogSigmoid(torch.autograd.Function):
    """``F.logsigmoid`` with its backward in elementwise operations, which
    DTensor shards (it has no strategy for ``aten.log_sigmoid_backward``).
    The backward is ATen's: g * (1 - z / (1 + z)) for x < 0, else
    g * z / (1 + z), z = exp(-|x|), with z the forward's own buffer where
    ATen keeps one (a plain CPU tensor): then the gradient is bit-equal to
    ``F.logsigmoid``'s."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import DTensor
        if isinstance(x, DTensor):
            out, z = F.logsigmoid(x), None
        else:
            out, z = torch.ops.aten.log_sigmoid_forward(x)
            z = z if z.numel() == x.numel() else None
        ctx.save_for_backward(x, z)
        return out

    @staticmethod
    def backward(ctx, g):
        x, z = ctx.saved_tensors
        if z is None:
            z = torch.exp(-torch.abs(x))
        s = z / (1 + z)
        return torch.where(x < 0, 1 - s, s) * g


def log_sigmoid(x):
    """``F.logsigmoid(x)``, differentiable on DTensors (``_LogSigmoid``)."""
    return _LogSigmoid.apply(x)


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


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _nll_lse(logits, labels, valid):
    """(lse - the label's logit, lse), fp32; labels < 0 read class 0."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    # the label's logit keeps its trailing dim until the subtraction: a
    # vocab-sharded DTensor's gather is a masked partial sum whose mask
    # has the index's shape
    ll = torch.gather(logits, -1, safe[..., None])
    return (lse[..., None] - ll)[..., 0], lse


def softmax_xent_sums(logits, labels, z_loss_coef: float = 1e-4):
    """Sum-reduced xent pieces for chunked accumulation.

    Returns (sum nll+z, sum nll, n_valid); the sums fp32."""
    valid = labels >= 0
    nll, lse = _nll_lse(logits, labels, valid)
    z = z_loss_coef * torch.square(lse)
    zero = torch.zeros_like(nll)
    return (torch.sum(torch.where(valid, nll + z, zero)),
            torch.sum(torch.where(valid, nll, zero)), torch.sum(valid))


def softmax_xent(logits, labels, z_loss_coef: float = 1e-4, mask=None):
    """Causal-LM cross-entropy with z-loss; labels<0 are ignored.

    logits (..., V) fp-any; labels (...,) int.
    """
    valid = labels >= 0
    if mask is not None:
        valid = torch.logical_and(valid, mask.bool())
    nll, lse = _nll_lse(logits, labels, valid)
    z = z_loss_coef * torch.square(lse)
    zero = torch.zeros_like(nll)
    per_tok = torch.where(valid, nll + z, zero)
    n = torch.clamp(torch.sum(valid), min=1)
    return torch.sum(per_tok) / n, {
        "nll": torch.sum(torch.where(valid, nll, zero)) / n, "ntokens": n}
