"""train_step / serve_step factories (twin of the reference's
``runtime/trainer.py``).

``make_train_step`` builds the step: gradients of ``lm.loss_fn`` by
``torch.autograd.grad``, optional microbatch accumulation, the AdamW
update.  The loss runs ``lm.forward``'s differentiable twins and launches
no kernel; the serve steps run ``lm.prefill`` and ``lm.decode_step``,
which do.  Every step takes plain tensors, or DTensors with
``runtime.sharding``'s placements under ``axis_rules`` (the reference's
sharded step; ``launch/dryrun.py`` on a fake group, gloo ranks in the
tests).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models.common import DEFAULT_RC, RuntimeConfig
from repro_torch.optim import OptConfig, adamw_update, init_opt_state
from repro_torch.pytree import tree_items, tree_leaves, tree_map, \
    tree_unflatten
from repro_torch.runtime.sharding import reshape


def _on(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def loss_and_grads(cfg: ArchConfig, params, batch, rc: RuntimeConfig):
    """((loss, metrics), grads) of ``lm.loss_fn`` at ``params`` by
    ``torch.autograd.grad`` (the reference's ``jax.value_and_grad(...,
    has_aux=True)``); all of it detached, grads a tree like ``params``."""
    paths = [k for k, _ in tree_items(params)]
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = lm.loss_fn(
            cfg, tree_unflatten(params, dict(zip(paths, leaves))), batch, rc)
        # a leaf the loss does not reach (the empty attention stack of a
        # hybrid shorter than its pattern) gets zeros, as jax.grad gives
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), \
        tree_unflatten(params, dict(zip(paths, grads)))


def make_train_step(cfg: ArchConfig, rc: RuntimeConfig = DEFAULT_RC,
                    opt_cfg: OptConfig = OptConfig(), *,
                    microbatches: int = 1, accum_dtype=torch.float32):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  ``batch`` holds numpy arrays or tensors; they go to the
    parameters' device.

    With ``microbatches`` k > 1 the batch is split along dim 0 into k
    microbatches whose gradients are summed in ``accum_dtype`` (bf16
    halves the accumulator, a documented precision trade) and divided by
    k; the loss is the microbatches' mean and the other metrics are the
    last microbatch's."""

    def grad_fn(params, batch):
        return loss_and_grads(cfg, params, batch, rc)

    def train_step(params, opt_state, batch):
        batch = _on(batch, tree_leaves(params)[0].device)
        if microbatches <= 1:
            (loss, metrics), grads = grad_fn(params, batch)
        else:
            k = microbatches
            for a in batch.values():
                assert a.shape[0] % k == 0, (a.shape, k)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                                   device=p.device), params)
            loss = 0.0
            for i in range(k):
                mb = {key: reshape(a, (k, a.shape[0] // k)
                                   + tuple(a.shape[1:]))[i]
                      for key, a in batch.items()}
                (mb_loss, metrics), g = grad_fn(params, mb)
                grads = tree_map(lambda acc, x: acc + x.to(accum_dtype),
                                 grads, g)
                loss = loss + mb_loss
            grads = tree_map(lambda g: g / k, grads)
            loss = loss / k
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             opt_cfg)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, rc: RuntimeConfig = DEFAULT_RC,
                      max_len: Optional[int] = None):
    def prefill_step(params, batch):
        return lm.prefill(cfg, params, batch, rc, max_len=max_len)
    return prefill_step


def make_decode_step(cfg: ArchConfig, rc: RuntimeConfig = DEFAULT_RC):
    def serve_step(params, tokens, cache):
        return lm.decode_step(cfg, params, tokens, cache, rc)
    return serve_step


def init_train_state(cfg: ArchConfig, generator: torch.Generator,
                     rc: RuntimeConfig = DEFAULT_RC,
                     opt_cfg: OptConfig = OptConfig(), device=None):
    """(params, opt_state): master weights (every leaf in
    ``rc.param_dtype``) from ``generator`` on ``device`` (default: the
    CUDA card; meta: the shapes alone, a checkpoint's template) and zero
    moments."""
    params = lm.init_params(cfg, generator, rc, device, master=True)
    return params, init_opt_state(params, opt_cfg)
