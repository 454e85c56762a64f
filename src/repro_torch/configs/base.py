"""Architecture configuration (own copy of the reference's ``configs/base.py``).

Only the fields the port's dense decoder reads are kept; the MoE, MLA,
RG-LRU and xLSTM sub-configs and the vlm/audio front-end fields arrive
with the families that use them.
``reduced()`` derives the smoke config exactly as the reference does,
so ``tinyllama-1.1b-smoke`` has the same shape on both sides.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense (the only family ported so far)
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
    source: str = ""

    @property
    def dh(self) -> int:
        return self.head_dim if self.head_dim is not None \
            else self.d_model // self.n_heads

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests (the reference's
        ``ArchConfig.reduced``, dense fields)."""
        return ArchConfig(
            name=self.name + "-smoke", family=self.family,
            n_layers=min(self.n_layers, 2), d_model=64,
            n_heads=4, n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=128 if self.d_ff else 0, vocab=256,
            head_dim=16, qkv_bias=self.qkv_bias, norm=self.norm,
            rope_theta=self.rope_theta, tie_embeddings=True,
            source="smoke")
