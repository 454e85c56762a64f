"""Stand-ins for every model input of the dry run (twin of the
reference's ``launch/specs.py``).

Each is a tensor on the ``meta`` device: the shape and dtype of the real
input, no data and no allocation.  Parameters and caches come from the
port's own ``lm.init_params`` and ``lm.init_cache`` on the meta device
(the reference uses ``jax.eval_shape``).  Token ids are int64, the
dtype the port's models index with.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.models.common import DEFAULT_RC, RuntimeConfig

META = torch.device("meta")


def _ids(*shape):
    return torch.empty(shape, dtype=torch.long, device=META)


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig,
                      rc: RuntimeConfig = DEFAULT_RC) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        t = _ids(B, S, cfg.n_codebooks)
        return {"tokens": t, "labels": t}
    if cfg.family == "vlm":
        nf = cfg.n_frontend_tokens
        return {
            "tokens": _ids(B, S - nf),
            "labels": _ids(B, S - nf),
            "vis_embeds": torch.empty((B, nf, cfg.d_model),
                                      dtype=rc.compute_dtype, device=META),
        }
    t = _ids(B, S)
    return {"tokens": t, "labels": t}


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeConfig,
                        rc: RuntimeConfig = DEFAULT_RC) -> Dict[str, Any]:
    b = train_batch_specs(cfg, shape, rc)
    b.pop("labels")
    return b


def decode_token_specs(cfg: ArchConfig, shape: ShapeConfig) -> Any:
    B = shape.global_batch
    if cfg.family == "audio":
        return _ids(B, cfg.n_codebooks)
    return _ids(B)


def cache_specs_abstract(cfg: ArchConfig, shape: ShapeConfig,
                         rc: RuntimeConfig = DEFAULT_RC):
    """Meta cache of ``shape``'s batch and length, for decode dry runs.
    ``pos`` is a host int (the port's caches keep it on the host), set to
    the last position, where a decode step reads the whole cache."""
    cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len, rc,
                          device=META)
    cache["pos"] = shape.seq_len - 1
    return cache


def params_abstract(cfg: ArchConfig, rc: RuntimeConfig = DEFAULT_RC, *,
                    master: bool = False):
    """Meta parameters: the serving placement, or with ``master`` every
    leaf in ``rc.param_dtype`` (training's master weights, the dtype the
    reference's ``init_params`` makes them in)."""
    return lm.init_params(cfg, torch.Generator(), rc, META,
                          master=master)


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                rc: RuntimeConfig = DEFAULT_RC) -> Dict[str, Any]:
    """All inputs for the step implied by shape.kind (excluding params/state)."""
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape, rc)}
    if shape.kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, shape, rc)}
    if shape.kind == "decode":
        return {"tokens": decode_token_specs(cfg, shape),
                "cache": cache_specs_abstract(cfg, shape, rc)}
    raise ValueError(shape.kind)
