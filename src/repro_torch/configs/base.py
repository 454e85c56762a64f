"""Architecture configuration (own copy of the reference's ``configs/base.py``).

Only the fields the port's dense and hybrid decoders read are kept; the
MoE, MLA and xLSTM sub-configs and the vlm/audio front-end fields arrive
with the families that use them.
``reduced()`` derives the smoke config exactly as the reference does,
so ``tinyllama-1.1b-smoke`` and ``recurrentgemma-2b-smoke`` have the
same shape on both sides.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma recurrent block (RG-LRU + conv1d) settings."""
    d_rnn: int = 0                 # recurrence width (lru_width)
    conv_width: int = 4
    window: int = 2048             # local-attention window for hybrid layers
    block_pattern: Tuple[str, ...] = ("rglru", "rglru", "attn")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | hybrid (the families ported)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default: d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"          # rmsnorm | layernorm | layernorm_nonparam
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    rglru: Optional[RGLRUConfig] = None
    source: str = ""

    @property
    def dh(self) -> int:
        return self.head_dim if self.head_dim is not None \
            else self.d_model // self.n_heads

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests (the reference's
        ``ArchConfig.reduced``, dense and hybrid fields)."""
        kw = dict(
            name=self.name + "-smoke", family=self.family,
            n_layers=min(self.n_layers, 2), d_model=64,
            n_heads=4, n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=128 if self.d_ff else 0, vocab=256,
            head_dim=16, qkv_bias=self.qkv_bias, norm=self.norm,
            rope_theta=self.rope_theta, tie_embeddings=True,
            source="smoke")
        if self.rglru is not None:
            kw["rglru"] = dataclasses.replace(self.rglru, d_rnn=64, window=32)
            kw["n_layers"] = 3  # one full (rglru, rglru, attn) pattern
        return ArchConfig(**kw)


def _pattern_for(cfg: ArchConfig):
    """Per-layer block types for hybrid archs."""
    if cfg.rglru is None:
        return ["attn"] * cfg.n_layers
    pat = cfg.rglru.block_pattern
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]
