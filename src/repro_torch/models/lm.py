"""Decoder LM, dense GQA family (twin of the dense branch of the
reference's ``models/lm.py``).

Entry points are plain functions of (cfg, params, ...): ``init_params``,
``params_from_jax``, ``embed_inputs``, ``lm_logits``, ``init_cache``,
``prefill`` and ``decode_step``.  Parameters are a nested dict with the
reference's pytree layout: layer parameters stacked on a leading layer
dim, weights in (in, out) layout.  The layer scan becomes a Python loop.

The cache is ``{"ck", "cv": (L,B,S,Hkv,dh), "pos": int}``, the reference's
layout, with ``pos`` a host int so that neither the kernels (which take
it by value) nor the serving loop's termination test need a device sync.
``decode_step`` writes the new position into the cache in place and
returns the same tensors with ``pos + 1``.

Other families raise ``NotImplementedError`` until they are ported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import ffn as ffn_lib
from repro_torch.models.common import (DEFAULT_RC, RuntimeConfig, apply_norm,
                                       dense_init, norm_params)
from repro_torch.runtime.device import resolve_device

Params = Dict[str, Any]

# parameter subtrees kept in the parameter dtype: the norms read their
# scale as fp32 (``scale.astype(float32)``), so casting it to a bf16
# compute dtype would change the result
_NORM_KEYS = ("ln", "out_norm")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported "
                                  "(dense only)")


def _place(tree, rc: RuntimeConfig, device, in_norm: bool = False):
    """Move a parameter tree to ``device``: norm parameters in the
    parameter dtype, every weight in the compute dtype.

    The reference casts each weight with ``.astype(x.dtype)`` where it
    is used; casting once at load gives the same values (the cast is the
    same rounding) and keeps the bf16 model at ~2.2 GB on the card.
    """
    if isinstance(tree, dict):
        return {k: _place(v, rc, device, in_norm or k in _NORM_KEYS)
                for k, v in tree.items()}
    return tree.to(device=device,
                   dtype=rc.param_dtype if in_norm else rc.compute_dtype)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ===========================================================================
# Parameters
# ===========================================================================

def _attn_params(cfg, g, L, dtype, device):
    d, dh, hq, hkv = cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads
    p = {
        "ln": norm_params(cfg.norm, d, dtype, device),
        "wq": dense_init(g, (L, d, hq * dh), dtype, device),
        "wk": dense_init(g, (L, d, hkv * dh), dtype, device),
        "wv": dense_init(g, (L, d, hkv * dh), dtype, device),
        "wo": dense_init(g, (L, hq * dh, d), dtype, device,
                         scale=0.02 / max(1.0, (2 * cfg.n_layers) ** 0.5)),
    }
    p["ln"] = {k: v.expand(L, d).clone() for k, v in p["ln"].items()}
    if cfg.qkv_bias:
        p.update(bq=torch.zeros((L, hq * dh), dtype=dtype, device=device),
                 bk=torch.zeros((L, hkv * dh), dtype=dtype, device=device),
                 bv=torch.zeros((L, hkv * dh), dtype=dtype, device=device))
    return p


def _mlp_params(cfg, g, L, dtype, device):
    d, f = cfg.d_model, cfg.d_ff
    p = {
        "ln": norm_params(cfg.norm, d, dtype, device),
        "w1": dense_init(g, (L, d, f), dtype, device),
        "w3": dense_init(g, (L, d, f), dtype, device),
        "w2": dense_init(g, (L, f, d), dtype, device,
                         scale=0.02 / max(1.0, (2 * cfg.n_layers) ** 0.5)),
    }
    p["ln"] = {k: v.expand(L, d).clone() for k, v in p["ln"].items()}
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator,
                rc: RuntimeConfig = DEFAULT_RC, device=None) -> Params:
    """Random parameters with the reference's shapes and init scales.

    ``generator`` must live on ``device`` (default: the CUDA card).  The
    numbers differ from ``lm.init_params`` for the same seed; to compare
    with the reference, convert its parameters with ``params_from_jax``.
    """
    _check_family(cfg)
    device = resolve_device(device)
    pd = rc.param_dtype
    d, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    params: Params = {
        "embed": dense_init(generator, (V, d), pd, device),
        "out_norm": norm_params(cfg.norm, d, pd, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, (d, V), pd, device)
    params["blocks"] = {"attn": _attn_params(cfg, generator, L, pd, device),
                        "mlp": _mlp_params(cfg, generator, L, pd, device)}
    return _place(params, rc, device)


def params_from_jax(cfg: ArchConfig, tree, rc: RuntimeConfig = DEFAULT_RC,
                    device=None) -> Params:
    """Parameters from the reference's ``lm.init_params`` pytree, which the
    caller has already converted to numpy arrays (nested dicts, stacked
    leading layer dim, (in, out) weights)."""
    _check_family(cfg)
    device = resolve_device(device)

    def to_torch(x):
        if isinstance(x, dict):
            return {k: to_torch(v) for k, v in x.items()}
        a = np.array(x)                   # a writable copy
        if a.dtype not in (np.float32, np.float64, np.float16):
            a = a.astype(np.float32)      # e.g. ml_dtypes bfloat16
        return torch.from_numpy(a)

    return _place(to_torch(tree), rc, device)


# ===========================================================================
# Embedding / head
# ===========================================================================

def embed_inputs(cfg: ArchConfig, params: Params, batch: Dict[str, Any],
                 rc: RuntimeConfig):
    """Returns h (B, S, D)."""
    _check_family(cfg)
    tokens = torch.as_tensor(batch["tokens"],
                             device=params["embed"].device).long()
    return params["embed"][tokens].to(rc.compute_dtype)


def lm_logits(cfg: ArchConfig, params: Params, h, rc: RuntimeConfig):
    h = apply_norm(cfg.norm, h, params["out_norm"])
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(h, w.to(h.dtype))


# ===========================================================================
# Blocks
# ===========================================================================

def _attn_full(cfg, rc, h, p, positions):
    x = apply_norm(cfg.norm, h, p["ln"])
    q, k, v = attn_lib.gqa_project_qkv(x, p, cfg, positions)
    o = attn_lib.flash_attention(q, k, v, causal=True,
                                 block_q=rc.flash_block_q,
                                 block_kv=rc.flash_block_kv)
    o = o.reshape(o.shape[:2] + (-1,))
    return h + torch.matmul(o, p["wo"].to(o.dtype)), (k, v)


def _mlp_full(cfg, rc, h, p):
    return h + ffn_lib.swiglu(apply_norm(cfg.norm, h, p["ln"]), p)


def _attn_decode(cfg, rc, h, p, ck, cv, pos, positions):
    x = apply_norm(cfg.norm, h, p["ln"])
    q, k, v = attn_lib.gqa_project_qkv(x, p, cfg, positions)
    attn_lib.cache_update(ck, k[:, 0], pos)
    attn_lib.cache_update(cv, v[:, 0], pos)
    o = attn_lib.decode_attention(q[:, 0], ck, cv, pos)
    o = o.reshape(o.shape[0], 1, -1)
    return h + torch.matmul(o, p["wo"].to(o.dtype))


# ===========================================================================
# Serving: cache init / prefill / decode
# ===========================================================================

def init_cache(cfg: ArchConfig, batch_size: int, max_len: int,
               rc: RuntimeConfig = DEFAULT_RC, device=None) -> Dict[str, Any]:
    """Zero-initialised decode cache."""
    _check_family(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.dh)
    z = dict(dtype=rc.compute_dtype, device=device)
    return {"ck": torch.zeros(shape, **z), "cv": torch.zeros(shape, **z),
            "pos": 0}


@torch.no_grad()
def prefill(cfg: ArchConfig, params: Params, batch: Dict[str, Any],
            rc: RuntimeConfig = DEFAULT_RC, max_len: Optional[int] = None):
    """Full-sequence pass that also builds the decode cache.

    Returns (last_logits, cache).  Caches are padded to ``max_len`` if
    given and longer than the prompt.
    """
    h = embed_inputs(cfg, params, batch, rc)
    B, S = h.shape[0], h.shape[1]
    positions = torch.arange(S, device=h.device)[None].expand(B, S)
    T = max_len if (max_len is not None and max_len > S) else S
    shape = (cfg.n_layers, B, T, cfg.n_kv_heads, cfg.dh)
    ck = torch.zeros(shape, dtype=rc.compute_dtype, device=h.device)
    cv = torch.zeros(shape, dtype=rc.compute_dtype, device=h.device)
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        p = _layer(blocks, i)
        h, (k, v) = _attn_full(cfg, rc, h, p["attn"], positions)
        ck[i, :, :S] = k
        cv[i, :, :S] = v
        h = _mlp_full(cfg, rc, h, p["mlp"])
    logits = lm_logits(cfg, params, h[:, -1:], rc)[:, 0]
    return logits, {"ck": ck, "cv": cv, "pos": S}


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Params, tokens, cache,
                rc: RuntimeConfig = DEFAULT_RC):
    """One decode step.  tokens (B,) int.

    Returns (logits (B, V), cache).  The cache tensors are updated in
    place; the returned dict holds them with ``pos`` advanced by one.
    """
    pos = int(cache["pos"])
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    B = tokens.shape[0]
    h = embed_inputs(cfg, params, {"tokens": tokens[:, None]}, rc)
    positions = torch.full((B, 1), pos, device=h.device)
    ck, cv = cache["ck"], cache["cv"]
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        p = _layer(blocks, i)
        h = _attn_decode(cfg, rc, h, p["attn"], ck[i], cv[i], pos, positions)
        h = _mlp_full(cfg, rc, h, p["mlp"])
    logits = lm_logits(cfg, params, h, rc)[:, 0]
    return logits, {"ck": ck, "cv": cv, "pos": pos + 1}
