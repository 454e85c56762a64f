"""Decoder LM: the reference's seven families (twin of its
``models/lm.py``):

  dense / vlm / audio : uniform (attn + SwiGLU) blocks; ``vlm`` prepends
                        precomputed patch embeddings (``vis_embeds``),
                        ``audio`` sums ``n_codebooks`` token embeddings and
                        predicts each codebook's logits
  moe (moe_every=2)   : groups of (attn+dense, attn+MoE)
  mla_moe             : layers of (MLA attn + MoE)
  hybrid              : groups of (rglru, rglru, local-attn) + a tail
  xlstm               : groups of (slstm_every - 1) mLSTM blocks + 1 sLSTM

Entry points are plain functions of (cfg, params, ...): ``init_params``,
``params_from_jax``, ``place_params``, ``embed_inputs``, ``lm_logits``,
``forward``, ``chunked_xent``, ``loss_fn``, ``init_cache``, ``prefill``
and ``decode_step``.  Parameters are a nested dict with the reference's
pytree layout: layer parameters stacked on a leading layer dim, weights
in (in, out) layout.  The layer scan becomes a Python loop.

Two placements of one tree: serving keeps weights in the compute dtype
(cast once at load), training keeps master weights, every leaf in the
parameter dtype (``master=True``), and the block bodies cast each weight
to the activations' dtype where they use it, as the reference does.

Caches keep the reference's layout, with ``pos`` a host int so that the
serving loop's termination test needs no device sync (the decode step
hands the body the position as a device tensor, so that a CUDA graph of
it replays at any position: ``models/decode_graph.py``):

- dense, vlm, audio: ``{"ck", "cv": (L,B,S,Hkv,dh), "pos"}``;
- hybrid: per group of (rglru, rglru, attn) the RG-LRU states
  ``rh0``/``rh1`` (G,B,d_rnn) fp32 and conv states ``rconv0``/``rconv1``
  (G,B,conv_width-1,d_rnn), the window ring ``wk``/``wv``
  (G,B,W,Hkv,dh), and for a tail of RG-LRU layers
  ``"tail": {"rh", "rconv"}``;
- moe: per group of ``moe_every`` (2) layers the two attention layers'
  ``cka``/``cva`` and ``ckb``/``cvb`` (G,B,S,Hkv,dh);
- mla_moe: MLA's compressed cache, ``cc`` (L,B,S,kv_lora) and the shared
  rope key ``ckr`` (L,B,S,qk_rope);
- xlstm: per group the mLSTM layers' matrix memory ``mC``
  (G,n_m,B,H,dh,dh), normaliser ``mn`` (G,n_m,B,H,dh) and stabiliser
  ``mm`` (G,n_m,B,H), all fp32, and conv state ``mconv`` (G,n_m,B,3,inner);
  the sLSTM layer's ``sc``, ``sn``, ``sh``, ``sm`` (G,B,D) fp32.  Its size
  does not grow with the sequence.

``decode_step`` updates the cache tensors in place and returns a dict
holding them with ``pos + 1``.  On the card, ``prefill`` takes its cache
leaves from a pool and ``decode_step`` replays a CUDA graph of its body
on them (``models/decode_graph.py``): a cache that is not a pool entry
(one restored from the host) is copied into one first, and the returned
dict holds the entry.

Tokens are (B, S) ids, (B, S, K) codebook ids for ``audio`` (decode:
(B,) and (B, K)); ``audio`` logits are (..., K, V).

``forward`` and ``loss_fn`` are differentiable and launch no kernel: the
kernels have no backward, so ``forward`` runs the twins of the
reference's jnp attention (``attention.blocked_attention``,
``blocked_local_attention``) and associative RG-LRU scan
(``recurrent.rglru_assoc_scan``), while ``prefill`` and ``decode_step``
(under ``torch.no_grad``) run the kernels.  ``forward`` returns the MoE
families' ``moe_aux``, ``moe_z`` and ``moe_dropped`` summed over layers;
each layer (or group of layers) runs under ``common.remat_wrap``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import decode_graph
from repro_torch.models import ffn as ffn_lib
from repro_torch.models import recurrent as rec_lib
from repro_torch.models.common import (DEFAULT_RC, RuntimeConfig, apply_norm,
                                       checkpoint, dense_init, log_sigmoid,
                                       norm_params, remat_wrap,
                                       softmax_xent_sums)
from repro_torch.pytree import tree_leaves
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime import sharding, trace
from repro_torch.runtime.sharding import (cache_leaf, local_call, reshape,
                                          seq_matmul, shard_activation,
                                          whole_dim)

Params = Dict[str, Any]

# parameter subtrees kept in the parameter dtype: the norms read their
# scale as fp32 (``scale.astype(float32)``), so casting it to a bf16
# compute dtype would change the result
_NORM_KEYS = ("ln", "ln_mlp", "out_norm", "c_norm", "gn")
# leaves read in fp32 whatever the dtypes: the RG-LRU decay ``lam``
# (created fp32, ``recurrent.py:36``) and the sLSTM's input weights,
# recurrent weights and bias (``slstm_seq`` reads them ``astype(float32)``)
_FP32_KEYS = ("lam", "w_in", "r", "b")
FAMILIES = ("dense", "vlm", "audio", "moe", "mla_moe", "hybrid", "xlstm")
_DENSE = ("dense", "vlm", "audio")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported "
                                  f"({', '.join(FAMILIES)} only)")


def _device(device) -> torch.device:
    """``resolve_device``, letting a meta device through: a meta tree has
    a parameter tree's shapes and dtypes and no values (the counterpart
    of ``jax.eval_shape``), as a checkpoint's template."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def _leaf_dtype(key: str, rc: RuntimeConfig, inherited, master: bool):
    if key == "lam" or (key in _FP32_KEYS and not master):
        return torch.float32
    if master or key in _NORM_KEYS:
        return rc.param_dtype
    return inherited


def _place(tree, rc: RuntimeConfig, device, dtype=None, master=False):
    """Move a parameter tree to ``device``.  Serving: norm parameters in
    the parameter dtype, ``lam`` and the sLSTM's fp32 leaves in fp32,
    every weight in the compute dtype.  ``master`` (training): every leaf
    in the parameter dtype, ``lam`` in fp32, as the reference's
    ``init_params`` makes them.

    The reference casts each weight with ``.astype(x.dtype)`` where it
    is used; casting once at load gives the same values (the cast is the
    same rounding) and keeps the bf16 models at half their fp32 size on
    the card.  Training cannot: AdamW updates the master weights, whose
    small updates a bf16 leaf would round away.
    """
    if isinstance(tree, dict):
        return {k: _place(v, rc, device, _leaf_dtype(k, rc, dtype, master),
                          master)
                for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype or rc.compute_dtype)


def place_params(params, rc: RuntimeConfig = DEFAULT_RC, device=None):
    """``params`` in the serving placement on ``device``: e.g. trained
    master weights cast for ``prefill`` and ``decode_step``."""
    return _place(params, rc, _device(device))


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _moe_groups(cfg: ArchConfig) -> int:
    """Groups of (attn+dense, attn+MoE) layers of the ``moe`` family."""
    every = cfg.moe.moe_every
    assert cfg.n_layers % every == 0, (cfg.n_layers, every)
    return cfg.n_layers // every


def _hybrid_group_counts(cfg: ArchConfig) -> Tuple[int, int]:
    """(n_groups of (rec,rec,attn), n_tail rec layers)."""
    pat = len(cfg.rglru.block_pattern)  # 3
    return cfg.n_layers // pat, cfg.n_layers % pat


def _xlstm_groups(cfg: ArchConfig) -> Tuple[int, int]:
    """(n_groups, mLSTM layers a group): each group is ``slstm_every``
    layers, the last of them sLSTM."""
    every = cfg.xlstm.slstm_every
    assert cfg.n_layers % every == 0, (cfg.n_layers, every)
    return cfg.n_layers // every, every - 1


def _mlstm_inner(cfg: ArchConfig) -> int:
    return int(cfg.xlstm.mlstm_proj_factor * cfg.d_model)


# ===========================================================================
# Parameters
# ===========================================================================

def _stacked_norm(cfg, L, dtype, device):
    """Norm parameters stacked on ``L`` (an int, or a tuple of leading
    dims)."""
    lead = L if isinstance(L, tuple) else (L,)
    return {k: v.expand(*lead, cfg.d_model).clone()
            for k, v in norm_params(cfg.norm, cfg.d_model, dtype,
                                    device).items()}


def _out_scale(cfg):
    return 0.02 / max(1.0, (2 * cfg.n_layers) ** 0.5)


def _attn_params(cfg, g, L, dtype, device):
    d, dh, hq, hkv = cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads
    p = {
        "ln": _stacked_norm(cfg, L, dtype, device),
        "wq": dense_init(g, (L, d, hq * dh), dtype, device),
        "wk": dense_init(g, (L, d, hkv * dh), dtype, device),
        "wv": dense_init(g, (L, d, hkv * dh), dtype, device),
        "wo": dense_init(g, (L, hq * dh, d), dtype, device,
                         scale=_out_scale(cfg)),
    }
    if cfg.qkv_bias:
        p.update(bq=torch.zeros((L, hq * dh), dtype=dtype, device=device),
                 bk=torch.zeros((L, hkv * dh), dtype=dtype, device=device),
                 bv=torch.zeros((L, hkv * dh), dtype=dtype, device=device))
    return p


def _mlp_params(cfg, g, L, dtype, device):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "ln": _stacked_norm(cfg, L, dtype, device),
        "w1": dense_init(g, (L, d, f), dtype, device),
        "w3": dense_init(g, (L, d, f), dtype, device),
        "w2": dense_init(g, (L, f, d), dtype, device, scale=_out_scale(cfg)),
    }


def _mla_params(cfg, g, L, dtype, device):
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    return {
        "ln": _stacked_norm(cfg, L, dtype, device),
        "w_q": dense_init(g, (L, d, H * (m.qk_nope_dim + m.qk_rope_dim)),
                          dtype, device),
        "w_dkv": dense_init(g, (L, d, m.kv_lora_rank + m.qk_rope_dim),
                            dtype, device),
        "c_norm": torch.zeros((L, m.kv_lora_rank), dtype=dtype,
                              device=device),
        "w_uk": dense_init(g, (L, m.kv_lora_rank, H * m.qk_nope_dim), dtype,
                           device),
        "w_uv": dense_init(g, (L, m.kv_lora_rank, H * m.v_head_dim), dtype,
                           device),
        "w_o": dense_init(g, (L, H * m.v_head_dim, d), dtype, device,
                          scale=_out_scale(cfg)),
    }


def _moe_params(cfg, g, L, dtype, device):
    e = cfg.moe
    d, E, f = cfg.d_model, e.num_experts, e.d_expert
    p = {
        "ln": _stacked_norm(cfg, L, dtype, device),
        "router": dense_init(g, (L, d, E), dtype, device),
        "w1": dense_init(g, (L, E, d, f), dtype, device),
        "w3": dense_init(g, (L, E, d, f), dtype, device),
        "w2": dense_init(g, (L, E, f, d), dtype, device,
                         scale=_out_scale(cfg)),
    }
    if e.num_shared > 0:
        sf = e.num_shared * f
        p["shared"] = {"w1": dense_init(g, (L, d, sf), dtype, device),
                       "w3": dense_init(g, (L, d, sf), dtype, device),
                       "w2": dense_init(g, (L, sf, d), dtype, device)}
    return p


def _rglru_block_params(cfg, g, L, dtype, device):
    r = cfg.rglru
    d, dr, H = cfg.d_model, r.d_rnn, cfg.n_heads
    dh = dr // H
    lo, hi = 0.65 ** 2, 0.999 ** 2
    lam = torch.rand((L, dr), generator=g, device=device) * (hi - lo) + lo
    lam = torch.log(torch.exp(torch.sqrt(lam) * 8.0) - 1.0) / 8.0
    z = dict(dtype=dtype, device=device)
    return {
        "ln": _stacked_norm(cfg, L, dtype, device),
        "w_y": dense_init(g, (L, d, dr), dtype, device),    # gated branch
        "w_xb": dense_init(g, (L, d, dr), dtype, device),   # recurrence
        "conv_w": dense_init(g, (L, r.conv_width, dr), dtype, device,
                             scale=0.1),
        "conv_b": torch.zeros((L, dr), **z),
        "w_a": dense_init(g, (L, H, dh, dh), dtype, device),
        "b_a": dense_init(g, (L, H, dh), dtype, device),
        "w_x": dense_init(g, (L, H, dh, dh), dtype, device),
        "b_x": torch.zeros((L, H, dh), **z),
        "lam": lam,
        "w_out": dense_init(g, (L, dr, d), dtype, device,
                            scale=_out_scale(cfg)),
    }


def _mlstm_params(cfg, g, lead, dtype, device):
    """mLSTM block parameters stacked on the leading dims ``lead``."""
    d, H, inner = cfg.d_model, cfg.n_heads, _mlstm_inner(cfg)
    z = dict(dtype=dtype, device=device)
    b_if = torch.cat([torch.zeros((H,), **z),
                      torch.full((H,), 3.0, **z)])       # forget bias
    return {
        "ln": _stacked_norm(cfg, lead, dtype, device),
        "w_up": dense_init(g, lead + (d, 2 * inner), dtype, device),  # u, z
        "conv_w": dense_init(g, lead + (4, inner), dtype, device,
                             scale=0.1),
        "conv_b": torch.zeros(lead + (inner,), **z),
        "w_q": dense_init(g, lead + (inner, inner), dtype, device),
        "w_k": dense_init(g, lead + (inner, inner), dtype, device),
        "w_if": dense_init(g, lead + (inner, 2 * H), dtype, device,
                           scale=0.01),
        "b_if": b_if.expand(lead + (2 * H,)).clone(),
        "gn": torch.ones(lead + (inner,), **z),
        "w_down": dense_init(g, lead + (inner, d), dtype, device,
                             scale=_out_scale(cfg)),
    }


def _slstm_params(cfg, g, G, dtype, device):
    """sLSTM block parameters stacked on G; ``w_in``, ``r`` and ``b`` in
    fp32, as ``slstm_seq`` reads them."""
    d, H = cfg.d_model, cfg.n_heads
    dh, f = d // H, int(cfg.xlstm.slstm_proj_factor * d)
    f32 = dict(dtype=torch.float32, device=device)
    b = torch.cat([torch.zeros((2 * d,), **f32), torch.full((d,), 2.0, **f32),
                   torch.zeros((d,), **f32)])            # z, i, f(+bias), o
    return {
        "ln": _stacked_norm(cfg, G, dtype, device),
        "ln_mlp": _stacked_norm(cfg, G, dtype, device),
        "w_in": dense_init(g, (G, d, 4 * d), torch.float32, device),
        "r": dense_init(g, (G, H, dh, 4 * dh), torch.float32, device,
                        scale=0.01),
        "b": b.expand(G, 4 * d).clone(),
        "gn": torch.ones((G, d), dtype=dtype, device=device),
        "mlp": {"w1": dense_init(g, (G, d, f), dtype, device),
                "w3": dense_init(g, (G, d, f), dtype, device),
                "w2": dense_init(g, (G, f, d), dtype, device)},
    }


def init_params(cfg: ArchConfig, generator: torch.Generator,
                rc: RuntimeConfig = DEFAULT_RC, device=None, *,
                master: bool = False) -> Params:
    """Random parameters with the reference's shapes and init scales.

    ``generator`` must live on ``device`` (default: the CUDA card; a meta
    device gives the tree's shapes and dtypes alone).  The numbers differ
    from ``lm.init_params`` for the same seed; to compare with the
    reference, convert its parameters with ``params_from_jax``.

    Serving: every leaf is made in the compute dtype, each stacked leaf
    one 2-D slice at a time (``dense_init``), so a bf16 model never holds
    its fp32 draw: DeepSeek-V2-Lite is 32.4 GB in bf16 and would need
    64.8 GB more in fp32.  The norm parameters (zeros or ones, exact in
    bf16) go back to the parameter dtype at ``_place``; the values equal
    a draw made in fp32 and cast once.  ``master`` (training): every leaf
    made in the parameter dtype; cast by ``place_params``, the same seed
    gives the serving tree.
    """
    _check_family(cfg)
    device = _device(device)
    g = generator
    wd = rc.param_dtype if master else rc.compute_dtype
    d, L = cfg.d_model, cfg.n_layers
    # audio: one table of K codebooks x V ids, logits for every codebook
    V = cfg.n_codebooks * cfg.vocab if cfg.family == "audio" else cfg.vocab
    params: Params = {
        "embed": dense_init(g, (V, d), wd, device),
        "out_norm": norm_params(cfg.norm, d, wd, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(g, (d, V), wd, device)
    if cfg.family in _DENSE:
        params["blocks"] = {"attn": _attn_params(cfg, g, L, wd, device),
                            "mlp": _mlp_params(cfg, g, L, wd, device)}
    elif cfg.family == "moe":
        G = _moe_groups(cfg)
        params["blocks"] = {"attn_a": _attn_params(cfg, g, G, wd, device),
                            "mlp": _mlp_params(cfg, g, G, wd, device),
                            "attn_b": _attn_params(cfg, g, G, wd, device),
                            "moe": _moe_params(cfg, g, G, wd, device)}
    elif cfg.family == "mla_moe":
        params["blocks"] = {"attn": _mla_params(cfg, g, L, wd, device),
                            "moe": _moe_params(cfg, g, L, wd, device)}
    elif cfg.family == "xlstm":
        G, n_m = _xlstm_groups(cfg)
        params["blocks"] = {"m": _mlstm_params(cfg, g, (G, n_m), wd, device),
                            "s": _slstm_params(cfg, g, G, wd, device)}
    else:
        G, tail = _hybrid_group_counts(cfg)
        params["blocks"] = {
            "rec0": _rglru_block_params(cfg, g, G, wd, device),
            "mlp0": _mlp_params(cfg, g, G, wd, device),
            "rec1": _rglru_block_params(cfg, g, G, wd, device),
            "mlp1": _mlp_params(cfg, g, G, wd, device),
            "attn": _attn_params(cfg, g, G, wd, device),
            "mlp2": _mlp_params(cfg, g, G, wd, device),
        }
        params["tail"] = {"rec": _rglru_block_params(cfg, g, tail, wd, device),
                          "mlp": _mlp_params(cfg, g, tail, wd, device)} \
            if tail else {}
    return _place(params, rc, device, master=master)


def params_from_jax(cfg: ArchConfig, tree, rc: RuntimeConfig = DEFAULT_RC,
                    device=None, *, master: bool = False) -> Params:
    """Parameters from the reference's ``lm.init_params`` pytree, which the
    caller has already converted to numpy arrays (nested dicts, stacked
    leading layer dim, (in, out) weights); placed for serving, or with
    ``master`` as training's master weights."""
    _check_family(cfg)
    device = resolve_device(device)

    def to_torch(x):
        if isinstance(x, dict):
            return {k: to_torch(v) for k, v in x.items()}
        a = np.array(x)                   # a writable copy
        if a.dtype not in (np.float32, np.float64, np.float16):
            a = a.astype(np.float32)      # e.g. ml_dtypes bfloat16
        return torch.from_numpy(a)

    return _place(to_torch(tree), rc, device, master=master)


# ===========================================================================
# Embedding / head
# ===========================================================================

def embed_inputs(cfg: ArchConfig, params: Params, batch: Dict[str, Any],
                 rc: RuntimeConfig):
    """Returns h (B, S, D): ``vlm`` with ``batch["vis_embeds"]`` (B, P, D)
    prepended, S = P + the text tokens; ``audio`` from (B, S, K) codebook
    ids, their K embeddings summed."""
    _check_family(cfg)
    emb = whole_dim(params["embed"], 0)
    tokens = torch.as_tensor(batch["tokens"], device=emb.device).long()
    if cfg.family == "audio":
        K = cfg.n_codebooks
        if tokens.dim() != 3 or tokens.shape[-1] != K:
            raise ValueError(f"{cfg.name} takes (B, S, K={K}) codebook "
                             f"tokens, got shape {tuple(tokens.shape)}")
        offs = torch.arange(K, device=emb.device) * cfg.vocab
        # summed in fp32 before the cast, as the reference sums its fp32
        # table's rows
        h = F.embedding(tokens + offs, emb).float().sum(dim=2)
    elif cfg.family == "vlm" and "vis_embeds" in batch:
        te = F.embedding(tokens, emb)
        vis = torch.as_tensor(batch["vis_embeds"], device=emb.device)
        h = torch.cat([vis.to(te.dtype), te], dim=1)
    else:
        h = F.embedding(tokens, emb)
    h = h.to(rc.compute_dtype)
    if cfg.family == "hybrid":            # gemma-style scaling
        # the scale is rounded to h's dtype first, as the reference's
        # jnp.asarray(d_model ** 0.5, h.dtype) is (50.5 in bf16); rounded
        # on the host, so that a CUDA graph can capture the product
        h = h * float(torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype))
    return h


def lm_logits(cfg: ArchConfig, params: Params, h, rc: RuntimeConfig):
    h = apply_norm(cfg.norm, h, params["out_norm"])
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = seq_matmul(h, w.to(h.dtype))
    if cfg.family == "audio":
        logits = reshape(logits, logits.shape[:-1]
                         + (cfg.n_codebooks, cfg.vocab))
    return logits


# ===========================================================================
# Blocks
# ===========================================================================

def _pad_heads(q, n_kv: int, multiple: int):
    """Pad each KV group of q (B,S,Hq,dh) with zero query heads until
    the head count is a multiple of ``multiple`` (the GQA head -> KV
    mapping is kept); returns (q, heads a group had, heads it has)."""
    B, S, Hq, dh = q.shape
    g = g_pad = Hq // n_kv
    while (n_kv * g_pad) % multiple:
        g_pad += 1
    qg = sharding.pad(reshape(q, (B, S, n_kv, g, dh)),
                      (0, 0, 0, g_pad - g))
    return qg.reshape(B, S, n_kv * g_pad, dh), g, g_pad


def _attn_full(cfg, rc, h, p, positions, *, window=None, train=False):
    """Returns (h, (k, v)); ``train`` runs the differentiable twins of
    the reference's jnp attention instead of the flash kernel.  With
    ``rc.pad_attn_heads`` the query heads are padded per KV group to a
    multiple of it and the padded heads dropped again before the output
    projection (exact)."""
    x = apply_norm(cfg.norm, h, p["ln"])
    q, k, v = attn_lib.gqa_project_qkv(x, p, cfg, positions)
    g = g_pad = 0
    if rc.pad_attn_heads > 1 and q.shape[2] % rc.pad_attn_heads != 0:
        q, g, g_pad = _pad_heads(q, cfg.n_kv_heads, rc.pad_attn_heads)
    q = shard_activation(q, "attn_in", rc)
    k = shard_activation(k, "attn_in", rc)
    v = shard_activation(v, "attn_in", rc)
    if window is not None:
        local = attn_lib.blocked_local_attention if train \
            else attn_lib.local_attention
        o = local(q, k, v, window=window, block_q=rc.flash_block_q)
    else:
        o = (attn_lib.blocked_attention if train
             else attn_lib.flash_attention)(
            q, k, v, causal=True, block_q=rc.flash_block_q,
            block_kv=rc.flash_block_kv)
    if g_pad != g:                          # drop padded heads (exact)
        B, S = o.shape[:2]
        o = reshape(o, (B, S, cfg.n_kv_heads, g_pad, -1))[:, :, :, :g]
    o = o.reshape(o.shape[:2] + (-1,))
    o = shard_activation(o, "attn_out", rc)
    delta = torch.matmul(o, p["wo"].to(o.dtype))
    return h + shard_activation(delta, "residual", rc), (k, v)


def _mla_full(cfg, rc, h, p, positions, *, train=False):
    """MLA prefill: decompressed keys and values through the flash kernel
    (dqk 192 against dv 128 at full width), or with ``train`` its
    differentiable twin.  Returns (h, (c, k_rope)), the compressed cache
    entries."""
    x = apply_norm(cfg.norm, h, p["ln"])
    q, k, v, c, kr = attn_lib.mla_prefill_qkv(x, p, cfg, positions)
    q = shard_activation(q, "attn_in", rc)
    k = shard_activation(k, "attn_in", rc)
    v = shard_activation(v, "attn_in", rc)
    o = (attn_lib.blocked_attention if train else attn_lib.flash_attention)(
        q, k, v, causal=True, block_q=rc.flash_block_q,
        block_kv=rc.flash_block_kv)
    w_o = reshape(p["w_o"].to(o.dtype), (cfg.n_heads, cfg.mla.v_head_dim, -1))
    o = torch.einsum("bshv,hvd->bsd", o, w_o)
    return h + shard_activation(o, "residual", rc), (c, kr)


def _mlp_full(cfg, rc, h, p, act=ffn_lib.swiglu):
    return h + act(apply_norm(cfg.norm, h, p["ln"]), p)


MOE_METRIC_KEYS = ("moe_aux", "moe_z", "moe_dropped")


def _moe_full(cfg, rc, h, p, aux):
    """Returns (h, aux) with the layer's MoE metrics added to ``aux``."""
    y, metrics = ffn_lib.moe_apply(apply_norm(cfg.norm, h, p["ln"]), p, cfg)
    return h + shard_activation(y, "residual", rc), \
        {k: aux[k] + metrics[k] for k in MOE_METRIC_KEYS}


def _moe_nometrics(cfg, h, p):
    """Routes each sequence of ``h`` (B,S,D) as its own row."""
    y, _ = ffn_lib.moe_dispatch(apply_norm(cfg.norm, h, p["ln"]), p, cfg)
    return h + y


def _moe_decode(cfg, h, p):
    """One decode step's MoE: the batch's B tokens routed as one row."""
    B = h.shape[0]
    x = apply_norm(cfg.norm, h, p["ln"])
    y, _ = ffn_lib.moe_dispatch(x.reshape(1, B, -1), p, cfg)
    return h + y.reshape(B, 1, -1)


def _rglru_full(cfg, rc, h, p, *, train=False):
    """Returns (h, (h_last fp32, conv_state)); ``train`` runs the
    associative scan instead of the scan kernel."""
    x = apply_norm(cfg.norm, h, p["ln"])
    y = ffn_lib.gelu(seq_matmul(x, p["w_y"].to(x.dtype)))
    xb = seq_matmul(x, p["w_xb"].to(x.dtype))
    xb, conv_state = rec_lib.causal_conv1d(xb, p["conv_w"], p["conv_b"])
    scan = rec_lib.rglru_assoc_scan if train else rec_lib.rglru_scan
    rec, h_last = scan(xb, p, cfg.n_heads)
    out = torch.matmul(rec * y, p["w_out"].to(x.dtype))
    return h + shard_activation(out, "residual", rc), (h_last, conv_state)


def _mlstm_qkv(cfg, p, x, conv=None):
    """x (B,S,D) -> q, k, v (B,S,H,dh), log_i / log_f (B,S,H) fp32, the
    output gate z (B,S,inner) and the conv state (B,3,inner); ``conv`` is
    the decode step's state.  v is the up-projection before the conv."""
    u, z = torch.chunk(seq_matmul(x, p["w_up"].to(x.dtype)), 2, dim=-1)
    uc, conv_state = rec_lib.causal_conv1d(u, p["conv_w"], p["conv_b"],
                                           state=conv)
    uc = F.silu(uc)
    q = torch.matmul(uc, p["w_q"].to(x.dtype))
    k = torch.matmul(uc, p["w_k"].to(x.dtype))
    gates = torch.matmul(uc, p["w_if"].to(x.dtype)) + p["b_if"].to(x.dtype)
    log_i, f_pre = torch.chunk(gates.float(), 2, dim=-1)

    def heads(t):
        return reshape(t, (t.shape[0], t.shape[1], cfg.n_heads, -1))
    return heads(q), heads(k), heads(u), log_i, log_sigmoid(f_pre), z, \
        conv_state


def _mlstm_out(cfg, h, p, hh, z):
    """The down-projection of the heads' outputs hh (..., H, dh),
    group-normed per head and gated by silu(z)."""
    hh = rec_lib.groupnorm_heads(reshape(hh, z.shape), p["gn"], cfg.n_heads)
    return torch.matmul(hh * F.silu(z), p["w_down"].to(h.dtype))


def _mlstm_full(cfg, rc, h, p, *, train=False):
    """mLSTM prefill: the chunkwise form when S is a multiple (> 1) of
    the chunk, else the parallel form and the final state.  ``train``
    keeps no state and runs the form on each rank's local shards of
    DTensors, batch and (where they divide) heads split, as the blocked
    attention does: DTensor's backward of its einsums fails once the
    batch is sharded over two mesh dims.  Returns (h, ((C, n, m) or
    None, conv_state))."""
    x = apply_norm(cfg.norm, h, p["ln"])
    q, k, v, log_i, log_f, z, conv_state = _mlstm_qkv(cfg, p, x)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))       # (B,H,S,dh)
    log_i, log_f = log_i.transpose(1, 2), log_f.transpose(1, 2)
    S, chunk = q.shape[2], cfg.xlstm.chunk
    chunked = S > chunk and S % chunk == 0
    state = None
    if train:
        def form(*qkv_gates):
            return rec_lib.mlstm_chunkwise(*qkv_gates, chunk=chunk)[0] \
                if chunked else rec_lib.mlstm_parallel(*qkv_gates)
        args = (q, k, v, log_i, log_f)
        hh = local_call(form, args, (("batch", "model", None, None),) * 3
                        + (("batch", "model", None),) * 2, 2) \
            if isinstance(q, DTensor) else form(*args)
    elif chunked:
        hh, state = rec_lib.mlstm_chunkwise(q, k, v, log_i, log_f,
                                            chunk=chunk)
    else:
        hh = rec_lib.mlstm_parallel(q, k, v, log_i, log_f)
        state = rec_lib.mlstm_final_state(q, k, v, log_i, log_f)
    out = shard_activation(_mlstm_out(cfg, h, p, hh.transpose(1, 2), z),
                           "residual", rc)
    return h + out, (state, conv_state)


def _mlstm_decode(cfg, rc, h, p, C, n, m, conv):
    """One mLSTM step; ``C``, ``n``, ``m`` (one layer's fp32 state) and
    ``conv`` (B,3,inner) are written in place."""
    x = apply_norm(cfg.norm, h, p["ln"])
    q, k, v, log_i, log_f, z, conv_state = _mlstm_qkv(cfg, p, x, conv)
    hh, new = rec_lib.mlstm_step(q[:, 0], k[:, 0], v[:, 0], log_i[:, 0],
                                 log_f[:, 0], (C, n, m))
    for t, t_new in zip((C, n, m, conv), new + (conv_state,)):
        t.copy_(t_new)
    return h + _mlstm_out(cfg, h, p, hh[:, None], z)


def _slstm_full(cfg, rc, h, p, state=None):
    """sLSTM block over h (B,S,D) from ``state`` (c, n, h, m); returns
    (h, new_state)."""
    x = apply_norm(cfg.norm, h, p["ln"])
    y, new_state = rec_lib.slstm_seq(x, p, cfg.n_heads, state=state)
    h = h + rec_lib.groupnorm_heads(y, p["gn"], cfg.n_heads)
    h = h + ffn_lib.geglu(apply_norm(cfg.norm, h, p["ln_mlp"]), p["mlp"])
    return h, new_state


# the xlstm cache's mLSTM state (C, n, m) and conv state, and sLSTM state
_MLSTM_KEYS = ("mC", "mn", "mm", "mconv")
_SLSTM_KEYS = ("sc", "sn", "sh", "sm")


def _window_cache(x, W: int):
    """The prefill's (B,S,...) keys or values as a W-slot ring: position
    t in slot t % W; padded with zeros when S < W.  The roll is two
    slices (torch 2.11's DTensor has no strategy for ``aten.roll``)."""
    S = x.shape[1]
    if S >= W:
        last, r = x[:, -W:], S % W
        return torch.cat([last[:, W - r:], last[:, :W - r]], dim=1)
    pad = torch.zeros((x.shape[0], W - S) + x.shape[2:], dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad], dim=1)


def _ring(pos, W: int):
    """(slot, last live slot) of position ``pos`` in a W-slot ring: pos % W
    and min(pos, W - 1), on the host or the device as ``pos`` is."""
    if isinstance(pos, torch.Tensor):
        return torch.remainder(pos, W), torch.clamp(pos, max=W - 1)
    return pos % W, min(pos, W - 1)


def _attn_decode(cfg, rc, h, p, ck, cv, pos, top, positions, window=None):
    """``ck``/``cv`` (B,S,Hkv,dh) are one layer's cache, written in place.
    With a window they are a ring: slot pos % W, and every slot is live
    once the ring is full.  RoPE uses the absolute ``pos``; the decode
    kernel takes the plan for ``top``."""
    x = apply_norm(cfg.norm, h, p["ln"])
    q, k, v = attn_lib.gqa_project_qkv(x, p, cfg, positions)
    if window is not None:
        W = ck.shape[1]
        (slot, pos_eff), top = _ring(pos, W), min(top, W - 1)
    else:
        slot = pos_eff = pos
    attn_lib.cache_update(ck, k[:, 0], slot, use_dus=rc.dus_cache_update)
    attn_lib.cache_update(cv, v[:, 0], slot, use_dus=rc.dus_cache_update)
    o = attn_lib.decode_attention(q[:, 0], ck, cv, pos_eff, pos_top=top)
    o = o.reshape(o.shape[0], 1, -1)
    return h + torch.matmul(o, p["wo"].to(o.dtype))


def _rglru_decode(cfg, rc, h, p, rh, rconv):
    """``rh`` (B,d_rnn) fp32 and ``rconv`` (B,W-1,d_rnn) are one layer's
    states, written in place."""
    x = apply_norm(cfg.norm, h, p["ln"])
    y = ffn_lib.gelu(torch.matmul(x, p["w_y"].to(x.dtype)))
    xb = torch.matmul(x, p["w_xb"].to(x.dtype))
    xb, conv_state = rec_lib.causal_conv1d(xb, p["conv_w"], p["conv_b"],
                                           state=rconv)
    rec, h_new = rec_lib.rglru_step(xb[:, 0], p, cfg.n_heads, rh)
    rh.copy_(h_new)
    rconv.copy_(conv_state)
    out = torch.matmul(rec * y[:, 0], p["w_out"].to(x.dtype))
    return h + out[:, None]


# ===========================================================================
# Full-sequence forward (train) and loss
# ===========================================================================

def _run_layers(rc, carry, blocks, body):
    """The reference's layer scan as a loop: ``carry = body(carry, p)``
    for each layer's slice ``p`` of the stacked ``blocks``, each layer
    under ``remat_wrap``; with ``remat_groups`` G > 1 dividing the layer
    count, each group of L / G layers also under a full checkpoint (the
    reference's double remat)."""
    L = tree_leaves(blocks)[0].shape[0]

    def constrained(c, p):
        c = body(c, p)
        if isinstance(c, tuple):
            return (shard_activation(c[0], "residual", rc),) + c[1:]
        return shard_activation(c, "residual", rc)
    layer = remat_wrap(constrained, rc)

    def run(c, lo, hi):
        for i in range(lo, hi):
            c = layer(c, _layer(blocks, i))
        return c

    G = rc.remat_groups
    if G > 1 and L % G == 0:
        n = L // G
        for g in range(G):
            carry = checkpoint(run, carry, g * n, (g + 1) * n)
        return carry
    return run(carry, 0, L)


def forward(cfg: ArchConfig, params: Params, batch: Dict[str, Any],
            rc: RuntimeConfig = DEFAULT_RC, return_hidden: bool = False):
    """Full-sequence forward -> (logits, or with ``return_hidden`` the
    pre-norm hidden state; metrics).  Differentiable; launches no
    kernel.  ``metrics`` holds the MoE families' ``MOE_METRIC_KEYS``
    summed over layers."""
    h = embed_inputs(cfg, params, batch, rc)
    B, S = h.shape[0], h.shape[1]
    positions = torch.arange(S, device=h.device)[None].expand(B, S)
    h = shard_activation(h, "residual", rc)
    metrics: Dict[str, Any] = {}
    fam, blocks = cfg.family, params["blocks"]
    geglu = ffn_lib.geglu

    def attn(h, p, window=None):
        return _attn_full(cfg, rc, h, p, positions, window=window,
                          train=True)[0]

    def rglru(h, p):
        return _rglru_full(cfg, rc, h, p, train=True)[0]

    if fam in _DENSE:
        def body(h, p):
            return _mlp_full(cfg, rc, attn(h, p["attn"]), p["mlp"])
        h = _run_layers(rc, h, blocks, body)
    elif fam in ("moe", "mla_moe"):
        def body(carry, p):
            h, aux = carry
            if fam == "moe":
                h = _mlp_full(cfg, rc, attn(h, p["attn_a"]), p["mlp"])
                h = attn(h, p["attn_b"])
            else:
                h = _mla_full(cfg, rc, h, p["attn"], positions,
                              train=True)[0]
            return _moe_full(cfg, rc, h, p["moe"], aux)
        aux0 = {k: torch.zeros((), device=h.device) for k in MOE_METRIC_KEYS}
        h, aux = _run_layers(rc, (h, aux0), blocks, body)
        metrics.update(aux)
    elif fam == "hybrid":
        def body(h, p):
            h = _mlp_full(cfg, rc, rglru(h, p["rec0"]), p["mlp0"], geglu)
            h = _mlp_full(cfg, rc, rglru(h, p["rec1"]), p["mlp1"], geglu)
            h = attn(h, p["attn"], window=cfg.rglru.window)
            return _mlp_full(cfg, rc, h, p["mlp2"], geglu)
        h = _run_layers(rc, h, blocks, body)
        for i in range(_hybrid_group_counts(cfg)[1]):
            p = _layer(params["tail"], i)
            h = _mlp_full(cfg, rc, rglru(h, p["rec"]), p["mlp"], geglu)
    elif fam == "xlstm":
        n_m = _xlstm_groups(cfg)[1]

        def body(h, p):
            for j in range(n_m):
                h = _mlstm_full(cfg, rc, h, _layer(p["m"], j),
                                train=True)[0]
            return _slstm_full(cfg, rc, h, p["s"])[0]
        h = _run_layers(rc, h, blocks, body)
    else:
        _check_family(cfg)

    if return_hidden:
        return h, metrics
    logits = shard_activation(lm_logits(cfg, params, h, rc), "logits", rc)
    return logits, metrics


LOSS_CHUNK = 512


def chunked_xent(cfg: ArchConfig, params: Params, h, labels,
                 rc: RuntimeConfig):
    """Cross-entropy without materializing full-sequence fp32 logits.

    S is taken in chunks of ``LOSS_CHUNK`` (or whole when S is not a
    multiple); each chunk projects h -> logits and reduces to sums under
    a checkpoint, so the backward recomputes a chunk's logits instead of
    keeping them.  h (B,S,D) normed; labels (B,S), audio (B,S,K).
    """
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    S = h.shape[1]
    chunk = LOSS_CHUNK if S % LOSS_CHUNK == 0 else S

    def body(hc, lc):
        logits = seq_matmul(hc, w.to(hc.dtype))
        if cfg.family == "audio":
            logits = reshape(logits, logits.shape[:-1]
                             + (cfg.n_codebooks, cfg.vocab))
        logits = shard_activation(logits, "logits", rc)
        return softmax_xent_sums(logits, lc, z_loss_coef=rc.z_loss)

    tot = nll = n = torch.zeros((), device=h.device)
    for c0 in range(0, S, chunk):
        t, n_, nv = checkpoint(body, h[:, c0:c0 + chunk],
                               labels[:, c0:c0 + chunk])
        tot, nll, n = tot + t, nll + n_, n + nv
    n = torch.clamp(n, min=1.0)
    return tot / n, {"nll": nll / n, "ntokens": n}


def loss_fn(cfg: ArchConfig, params: Params, batch: Dict[str, Any],
            rc: RuntimeConfig = DEFAULT_RC):
    """(loss, metrics): the z-lossed cross-entropy of ``batch["labels"]``
    (< 0 ignored) plus the MoE families' ``moe_aux`` and ``moe_z``.  A
    vlm batch's patch positions carry no label."""
    h, metrics = forward(cfg, params, batch, rc, return_hidden=True)
    labels = torch.as_tensor(batch["labels"], device=h.device).long()
    if cfg.family == "vlm" and "vis_embeds" in batch:
        nf = batch["vis_embeds"].shape[1]
        pad = torch.full(labels.shape[:1] + (nf,), -1, dtype=labels.dtype,
                         device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    h = apply_norm(cfg.norm, h, params["out_norm"])
    loss, lm_metrics = chunked_xent(cfg, params, h, labels, rc)
    metrics.update(lm_metrics)
    for k in ("moe_aux", "moe_z"):
        if k in metrics:
            loss = loss + metrics[k]
    metrics["loss"] = loss
    return loss, metrics


# ===========================================================================
# Serving: cache init / prefill / decode
# ===========================================================================

def init_cache(cfg: ArchConfig, batch_size: int, max_len: int,
               rc: RuntimeConfig = DEFAULT_RC, device=None,
               make=None) -> Dict[str, Any]:
    """Zero-initialised decode cache (on a meta device: its shapes).
    ``make(path, shape, dtype, fill)``, where given, makes each leaf (a
    sharded prefill's, ``runtime.sharding.cache_leaf``)."""
    _check_family(cfg)
    device = _device(device)
    B, dt = batch_size, rc.compute_dtype

    def z(*shape, dtype=dt, fill=0.0):
        return (shape, dtype, fill)

    kv = (cfg.n_kv_heads, cfg.dh)
    if cfg.family in _DENSE:
        cache = {"ck": z(cfg.n_layers, B, max_len, *kv),
                 "cv": z(cfg.n_layers, B, max_len, *kv)}
    elif cfg.family == "moe":
        G = _moe_groups(cfg)
        cache = {k: z(G, B, max_len, *kv) for k in ("cka", "cva", "ckb",
                                                      "cvb")}
    elif cfg.family == "mla_moe":
        m = cfg.mla
        cache = {"cc": z(cfg.n_layers, B, max_len, m.kv_lora_rank),
                 "ckr": z(cfg.n_layers, B, max_len, m.qk_rope_dim)}
    elif cfg.family == "xlstm":
        G, n_m = _xlstm_groups(cfg)
        H, D, inner = cfg.n_heads, cfg.d_model, _mlstm_inner(cfg)
        dh, f32 = inner // H, torch.float32
        cache = {"mC": z(G, n_m, B, H, dh, dh, dtype=f32),
                 "mn": z(G, n_m, B, H, dh, dtype=f32),
                 "mm": z(G, n_m, B, H, dtype=f32, fill=-1e30),
                 "mconv": z(G, n_m, B, 3, inner),
                 "sc": z(G, B, D, dtype=f32), "sn": z(G, B, D, dtype=f32),
                 "sh": z(G, B, D, dtype=f32),
                 "sm": z(G, B, D, dtype=f32, fill=-10.0)}
    else:
        G, tail = _hybrid_group_counts(cfg)
        r = cfg.rglru
        W = min(r.window, max_len)
        cache = {
            "rh0": z(G, B, r.d_rnn, dtype=torch.float32),
            "rconv0": z(G, B, r.conv_width - 1, r.d_rnn),
            "rh1": z(G, B, r.d_rnn, dtype=torch.float32),
            "rconv1": z(G, B, r.conv_width - 1, r.d_rnn),
            "wk": z(G, B, W, *kv),
            "wv": z(G, B, W, *kv),
        }
        if tail:
            cache["tail"] = {
                "rh": z(tail, B, r.d_rnn, dtype=torch.float32),
                "rconv": z(tail, B, r.conv_width - 1, r.d_rnn),
            }

    def build(tree, path=()):
        if isinstance(tree, dict):
            return {k: build(v, path + (k,)) for k, v in tree.items()}
        shape, dtype, fill = tree
        if make is not None:
            return make(path, shape, dtype, fill)
        return torch.full(shape, fill, dtype=dtype, device=device)
    cache = build(cache)
    cache["pos"] = 0
    return cache


def _put(leaf, i: int, t) -> None:
    """Write layer ``i``'s prompt entries ``t`` (B, S, ...) into ``leaf``
    (L, B, T, ...), zero past S.  The whole layer is written: a slice of
    a cache sharded on T would write each shard's own slice."""
    pad = leaf.shape[2] - t.shape[1]
    if pad:
        t = sharding.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    leaf[i] = t


def _prefill_cache(cfg, B: int, T: int, rc: RuntimeConfig, h, params):
    """The cache a prefill of activations ``h`` fills: zeros on h's
    device, each rank making its shards alone when h is sharded; on the
    card, the leaves of a free entry of ``params``' cache pool."""
    make = cache_leaf(h)
    if make is None and h.device.type == "cuda" \
            and not isinstance(h, DTensor):
        layout = []
        init_cache(cfg, B, T, rc, "meta", make=lambda path, shape, dtype,
                   fill: layout.append((tuple(path), tuple(shape), dtype)))
        make = decode_graph.take(decode_graph.model_of(params, h.device),
                                 tuple(layout), h.device).make
    return init_cache(cfg, B, T, rc, h.device, make=make)


@torch.no_grad()
def prefill(cfg: ArchConfig, params: Params, batch: Dict[str, Any],
            rc: RuntimeConfig = DEFAULT_RC, max_len: Optional[int] = None):
    """Full-sequence pass that also builds the decode cache.

    Returns (last_logits, cache).  Dense, vlm, audio, moe and mla_moe
    caches are padded to ``max_len`` if given and longer than the prompt
    (a vlm prompt's length counts its patch embeddings).  The hybrid
    cache is not: its window ring has ``window`` slots whatever the
    prompt, as in the reference (``lm.py:329-339,714-719``); nor is the
    xlstm state, whose size is fixed.  While the tracer is on, the call
    is a span ``model.prefill``.
    """
    with trace.span("model.prefill", tokens=int(batch["tokens"].shape[1])) \
            if trace.ON else trace.NULL:
        return _prefill(cfg, params, batch, rc, max_len)


def _prefill(cfg: ArchConfig, params: Params, batch: Dict[str, Any],
             rc: RuntimeConfig, max_len: Optional[int]):
    h = embed_inputs(cfg, params, batch, rc)
    B, S = h.shape[0], h.shape[1]
    positions = torch.arange(S, device=h.device)[None].expand(B, S)
    h = shard_activation(h, "residual", rc)
    blocks = params["blocks"]
    T = max_len if (max_len is not None and max_len > S) else S
    if cfg.family in _DENSE:
        cache = _prefill_cache(cfg, B, T, rc, h, params)
        for i in range(cfg.n_layers):
            p = _layer(blocks, i)
            h, (k, v) = _attn_full(cfg, rc, h, p["attn"], positions)
            _put(cache["ck"], i, k)
            _put(cache["cv"], i, v)
            h = shard_activation(_mlp_full(cfg, rc, h, p["mlp"]),
                                 "residual", rc)
    elif cfg.family == "moe":
        cache = _prefill_cache(cfg, B, T, rc, h, params)
        for i in range(_moe_groups(cfg)):
            p = _layer(blocks, i)
            h, (k, v) = _attn_full(cfg, rc, h, p["attn_a"], positions)
            _put(cache["cka"], i, k)
            _put(cache["cva"], i, v)
            h = _mlp_full(cfg, rc, h, p["mlp"])
            h, (k, v) = _attn_full(cfg, rc, h, p["attn_b"], positions)
            _put(cache["ckb"], i, k)
            _put(cache["cvb"], i, v)
            h = shard_activation(_moe_nometrics(cfg, h, p["moe"]),
                                 "residual", rc)
    elif cfg.family == "mla_moe":
        cache = _prefill_cache(cfg, B, T, rc, h, params)
        for i in range(cfg.n_layers):
            p = _layer(blocks, i)
            h, (c, kr) = _mla_full(cfg, rc, h, p["attn"], positions)
            _put(cache["cc"], i, c)
            _put(cache["ckr"], i, kr)
            h = shard_activation(_moe_nometrics(cfg, h, p["moe"]),
                                 "residual", rc)
    elif cfg.family == "xlstm":
        G, n_m = _xlstm_groups(cfg)
        cache = _prefill_cache(cfg, B, S, rc, h, params)
        for i in range(G):
            p = _layer(blocks, i)
            for j in range(n_m):
                h, ((C, n, m), conv) = _mlstm_full(cfg, rc, h,
                                                   _layer(p["m"], j))
                for key, t in zip(_MLSTM_KEYS, (C, n, m, conv)):
                    cache[key][i, j] = t
            h, state = _slstm_full(cfg, rc, h, p["s"])
            for key, t in zip(_SLSTM_KEYS, state):
                cache[key][i] = t
    else:
        G, n_tail = _hybrid_group_counts(cfg)
        W = cfg.rglru.window
        cache = _prefill_cache(cfg, B, W, rc, h, params)
        geglu = ffn_lib.geglu
        for i in range(G):
            p = _layer(blocks, i)
            h, (cache["rh0"][i], cache["rconv0"][i]) = \
                _rglru_full(cfg, rc, h, p["rec0"])
            h = _mlp_full(cfg, rc, h, p["mlp0"], geglu)
            h, (cache["rh1"][i], cache["rconv1"][i]) = \
                _rglru_full(cfg, rc, h, p["rec1"])
            h = _mlp_full(cfg, rc, h, p["mlp1"], geglu)
            h, (k, v) = _attn_full(cfg, rc, h, p["attn"], positions,
                                   window=W)
            cache["wk"][i] = _window_cache(k, W)
            cache["wv"][i] = _window_cache(v, W)
            h = shard_activation(_mlp_full(cfg, rc, h, p["mlp2"], geglu),
                                 "residual", rc)
        tc = cache.get("tail")
        for i in range(n_tail):
            p = _layer(params["tail"], i)
            h, (tc["rh"][i], tc["rconv"][i]) = \
                _rglru_full(cfg, rc, h, p["rec"])
            h = _mlp_full(cfg, rc, h, p["mlp"], geglu)
    cache["pos"] = S
    logits = lm_logits(cfg, params, h[:, -1:], rc)[:, 0]
    return logits, cache


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Params, tokens, cache,
                rc: RuntimeConfig = DEFAULT_RC):
    """One decode step.  tokens (B,) int (audio: (B, K)).

    Returns (logits (B, V), audio (B, K, V); cache).  The cache tensors
    are updated in place; the returned dict holds them with ``pos``
    advanced by one.  On the card the step is a replay of a CUDA graph
    of its body (``models/decode_graph.py``), and the returned dict holds
    a pool entry (a cache that is none is copied into one first).  While
    the tracer is on, the call is a span ``model.decode_step``.
    """
    with trace.span("model.decode_step", pos=cache["pos"]) \
            if trace.ON else trace.NULL:
        return decode_graph.step(
            cfg, params, tokens, cache, rc, _plan_reach(cfg, cache),
            lambda t, c, pos, top: _decode_step(cfg, params, t, c, rc, pos,
                                                top))


def _plan_reach(cfg: ArchConfig, cache) -> Optional[int]:
    """The cache slots the decode kernel plans over: a layer's cache
    length, the hybrid's window ring; None for the families whose decode
    launches no decode kernel (MLA's decode is PyTorch operations,
    xLSTM has no attention)."""
    if cfg.family in _DENSE:
        return cache["ck"].shape[2]
    if cfg.family == "moe":
        return cache["cka"].shape[2]
    if cfg.family == "hybrid":
        return cache["wk"].shape[2]
    return None


def _decode_step(cfg: ArchConfig, params: Params, tokens, cache,
                 rc: RuntimeConfig, pos, top: Optional[int]):
    """The step's body: the logits.  ``pos`` is the position, a 0-d int64
    tensor on the parameters' device (a host int where they are
    DTensors); ``top`` the position whose plan the decode kernel takes
    (``pos`` or past it).  The cache is written in place; nothing reads
    ``cache["pos"]``."""
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    B = tokens.shape[0]
    h = embed_inputs(cfg, params, {"tokens": tokens[:, None]}, rc)
    positions = attn_lib.positions_at(pos, B, h.device)
    blocks = params["blocks"]
    c = cache
    if cfg.family in _DENSE:
        for i in range(cfg.n_layers):
            p = _layer(blocks, i)
            h = _attn_decode(cfg, rc, h, p["attn"], c["ck"][i], c["cv"][i],
                             pos, top, positions)
            h = _mlp_full(cfg, rc, h, p["mlp"])
    elif cfg.family == "moe":
        for i in range(_moe_groups(cfg)):
            p = _layer(blocks, i)
            h = _attn_decode(cfg, rc, h, p["attn_a"], c["cka"][i],
                             c["cva"][i], pos, top, positions)
            h = _mlp_full(cfg, rc, h, p["mlp"])
            h = _attn_decode(cfg, rc, h, p["attn_b"], c["ckb"][i],
                             c["cvb"][i], pos, top, positions)
            h = _moe_decode(cfg, h, p["moe"])
    elif cfg.family == "mla_moe":
        for i in range(cfg.n_layers):
            p = _layer(blocks, i)
            x = apply_norm(cfg.norm, h, p["attn"]["ln"])
            h = h + attn_lib.mla_decode(x[:, 0], p["attn"], cfg, c["cc"][i],
                                        c["ckr"][i], pos)[:, None]
            h = _moe_decode(cfg, h, p["moe"])
    elif cfg.family == "xlstm":
        G, n_m = _xlstm_groups(cfg)
        for i in range(G):
            p = _layer(blocks, i)
            for j in range(n_m):
                h = _mlstm_decode(cfg, rc, h, _layer(p["m"], j),
                                  *(c[k][i, j] for k in _MLSTM_KEYS))
            h, state = _slstm_full(cfg, rc, h, p["s"],
                                   tuple(c[k][i] for k in _SLSTM_KEYS))
            for key, t in zip(_SLSTM_KEYS, state):
                c[key][i].copy_(t)
    else:
        G, n_tail = _hybrid_group_counts(cfg)
        geglu = ffn_lib.geglu
        for i in range(G):
            p = _layer(blocks, i)
            h = _rglru_decode(cfg, rc, h, p["rec0"], c["rh0"][i],
                              c["rconv0"][i])
            h = _mlp_full(cfg, rc, h, p["mlp0"], geglu)
            h = _rglru_decode(cfg, rc, h, p["rec1"], c["rh1"][i],
                              c["rconv1"][i])
            h = _mlp_full(cfg, rc, h, p["mlp1"], geglu)
            h = _attn_decode(cfg, rc, h, p["attn"], c["wk"][i], c["wv"][i],
                             pos, top, positions, window=cfg.rglru.window)
            h = _mlp_full(cfg, rc, h, p["mlp2"], geglu)
        for i in range(n_tail):
            p = _layer(params["tail"], i)
            h = _rglru_decode(cfg, rc, h, p["rec"], c["tail"]["rh"][i],
                              c["tail"]["rconv"][i])
            h = _mlp_full(cfg, rc, h, p["mlp"], geglu)
    return lm_logits(cfg, params, h, rc)[:, 0]
