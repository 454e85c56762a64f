"""AdamW with warmup+cosine schedule, global-norm clipping, and
memory-frugal (bf16 or per-tensor scaled int8) first/second moments
(twin of the reference's ``optim/adamw.py``).

The state is ``{"m", "v", "step"}`` (int8: also ``"m_scale"``,
``"v_scale"``), ``m`` and ``v`` trees of the parameters' shape, ``step``
a 0-d int32 tensor.  Each leaf's update keeps the reference's order of
operations; trees are walked in its sorted-key order (``pytree``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.pytree import from_numpy, tree_leaves, tree_map
from repro_torch.runtime.device import resolve_device


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: torch.dtype = torch.bfloat16  # bf16 halves optimizer memory
    # 8-bit moments (per-tensor scaled int8, Dettmers-style): 4 B/param of
    # optimizer state in all
    moments_int8: bool = False


def lr_schedule(cfg: OptConfig, step):
    """The learning rate at ``step`` (an int or a tensor) as an fp32
    tensor: linear warmup, then cosine decay to ``min_lr_frac`` of it."""
    step = torch.as_tensor(step).float()
    warm = cfg.lr * (step + 1) / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params, cfg: OptConfig) -> Dict[str, Any]:
    """Zero moments beside ``params`` (on their device; a meta tree gives
    a meta state, a checkpoint's template)."""
    dev = tree_leaves(params)[0].device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.moments_int8:
        def zq(p):
            return torch.zeros(p.shape, dtype=torch.int8, device=p.device)

        def sc(p):
            return torch.ones((), dtype=torch.float32, device=p.device)
        return {"m": tree_map(zq, params), "v": tree_map(zq, params),
                "m_scale": tree_map(sc, params),
                "v_scale": tree_map(sc, params), "step": step}

    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": step}


def opt_state_from_jax(tree, device=None) -> Dict[str, Any]:
    """The port's optimizer state from the reference's, which the caller
    has converted to numpy arrays (bf16 moments as ``ml_dtypes`` arrays,
    int8 moments, fp32 scales, the int32 step): the same values and
    dtypes on ``device``."""
    device = resolve_device(device)
    return tree_map(lambda a: from_numpy(a).to(device), tree)


def global_norm(tree):
    """sqrt of the sum of squares of every leaf (in fp32), the leaves
    summed in sorted-key order."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def _split(out, n):
    return [tree_map(lambda t, i=i: t[i], out) for i in range(n)]


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig):
    """Returns (new_params, new_state, {"grad_norm", "lr"})."""
    step = state["step"]
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.clip_norm > 0 else 1.0
    lr = lr_schedule(cfg, step)
    c1 = 1.0 - cfg.b1 ** (step.float() + 1)
    c2 = 1.0 - cfg.b2 ** (step.float() + 1)

    def common(p, g, m32, v32):
        m32 = cfg.b1 * m32 + (1 - cfg.b1) * g
        v32 = cfg.b2 * v32 + (1 - cfg.b2) * torch.square(g)
        delta = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        if p.dim() >= 2:  # decay matrices only (norms/bias exempt)
            delta = delta + cfg.weight_decay * p.float()
        newp = (p.float() - lr * delta).to(p.dtype)
        return newp, m32, v32

    if cfg.moments_int8:
        def upd8(p, g, mq, ms, vq, vs):
            g = g.float() * scale
            newp, m32, v32 = common(p, g, mq.float() * ms, vq.float() * vs)
            ms2 = torch.clamp(torch.max(torch.abs(m32)), min=1e-12) / 127.0
            vs2 = torch.clamp(torch.max(v32), min=1e-12) / 127.0
            mq2 = torch.clamp(torch.round(m32 / ms2), -127, 127).to(
                torch.int8)
            vq2 = torch.clamp(torch.round(v32 / vs2), 0, 127).to(torch.int8)
            return newp, mq2, ms2, vq2, vs2

        out = tree_map(upd8, params, grads, state["m"], state["m_scale"],
                       state["v"], state["v_scale"])
        newp, m, ms, v, vs = _split(out, 5)
        new_state = {"m": m, "m_scale": ms, "v": v, "v_scale": vs,
                     "step": step + 1}
        return newp, new_state, {"grad_norm": gnorm, "lr": lr}

    def upd(p, g, m, v):
        g = g.float() * scale
        newp, m32, v32 = common(p, g, m.float(), v.float())
        return newp, m32.to(cfg.moment_dtype), v32.to(cfg.moment_dtype)

    newp, m, v = _split(tree_map(upd, params, grads, state["m"],
                                 state["v"]), 3)
    return newp, {"m": m, "v": v, "step": step + 1}, \
        {"grad_norm": gnorm, "lr": lr}
