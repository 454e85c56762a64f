"""Architecture configuration (own copy of the reference's ``configs/base.py``).

Every field of the reference's ``ArchConfig`` and its sub-configs is
here, because ``core/program.py::workload_library`` builds an ``arch:``
program from every entry of ``ARCHS``.  The port's models cover all
seven families (``models/lm.py::FAMILIES``).
``reduced()`` derives the smoke config exactly as the reference does,
so every ``-smoke`` config has the same shape on both sides.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0           # routed experts
    num_shared: int = 0            # shared (always-on) experts
    top_k: int = 1
    d_expert: int = 0              # per-expert FFN hidden size
    moe_every: int = 1             # MoE FFN every k-th layer (others dense)
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_coef: float = 1e-2


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma recurrent block (RG-LRU + conv1d) settings."""
    d_rnn: int = 0                 # recurrence width (lru_width)
    conv_width: int = 4
    window: int = 2048             # local-attention window for hybrid layers
    block_pattern: Tuple[str, ...] = ("rglru", "rglru", "attn")


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 4           # one sLSTM block per this many layers
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    chunk: int = 256               # chunkwise-parallel mLSTM chunk length


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | mla_moe | hybrid | xlstm | vlm | audio
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
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rglru: Optional[RGLRUConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # modality frontends (stubs — precomputed embeddings via input_specs)
    n_frontend_tokens: int = 0     # vlm: image patch embeds prepended
    n_codebooks: int = 1           # audio: EnCodec codebooks (summed embeds)
    source: str = ""

    @property
    def dh(self) -> int:
        return self.head_dim if self.head_dim is not None \
            else self.d_model // self.n_heads

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests (the reference's
        ``ArchConfig.reduced``)."""
        kw = dict(
            name=self.name + "-smoke", family=self.family,
            n_layers=min(self.n_layers, 2), d_model=64,
            n_heads=4, n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=128 if self.d_ff else 0, vocab=256,
            head_dim=16, qkv_bias=self.qkv_bias, norm=self.norm,
            rope_theta=self.rope_theta, tie_embeddings=True,
            n_frontend_tokens=min(self.n_frontend_tokens, 8),
            n_codebooks=self.n_codebooks, source="smoke")
        if self.moe is not None:
            # capacity_factor=8 -> drop-free routing
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, num_shared=min(self.moe.num_shared, 1),
                top_k=min(self.moe.top_k, 2), d_expert=32,
                capacity_factor=8.0)
        if self.mla is not None:
            kw["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                                  v_head_dim=16)
        if self.rglru is not None:
            kw["rglru"] = dataclasses.replace(self.rglru, d_rnn=64, window=32)
            kw["n_layers"] = 3  # one full (rglru, rglru, attn) pattern
        if self.xlstm is not None:
            kw["xlstm"] = dataclasses.replace(self.xlstm, slstm_every=2, chunk=16)
        return ArchConfig(**kw)


def _pattern_for(cfg: ArchConfig):
    """Per-layer block types for hybrid archs."""
    if cfg.rglru is None:
        return ["attn"] * cfg.n_layers
    pat = cfg.rglru.block_pattern
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]
