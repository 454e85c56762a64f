"""Architecture and shape configuration (own copy of the reference's
``configs/base.py``).

Every field of the reference's ``ArchConfig`` and its sub-configs is
here, because ``core/program.py::workload_library`` builds an ``arch:``
program from every entry of ``ARCHS``.  The port's models cover all
seven families (``models/lm.py::FAMILIES``).
``reduced()`` derives the smoke config exactly as the reference does,
so every ``-smoke`` config has the same shape on both sides.
Every workload shape is a :class:`ShapeConfig`; ``(arch, shape)`` pairs
are the dry run's cells (``launch/dryrun.py``).
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

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports O(1)-state decode (may run long_500k)."""
        return self.family in ("hybrid", "xlstm")

    def param_count(self) -> int:
        """Approximate total parameter count (embeddings + blocks)."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family == "xlstm":
            per = 6 * d * d  # rough: qkv/proj + gates
            return emb + L * per
        dh, hq, hkv = self.dh, self.n_heads, self.n_kv_heads
        attn = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
        if self.mla is not None:
            m = self.mla
            attn = (d * (m.kv_lora_rank + m.qk_rope_dim)
                    + m.kv_lora_rank * hq * (m.qk_nope_dim + m.v_head_dim)
                    + d * hq * (m.qk_nope_dim + m.qk_rope_dim)
                    + hq * m.v_head_dim * d)
        if self.moe is not None:
            e = self.moe
            moe_frac = 1.0 / e.moe_every
            moe_ffn = (e.num_experts + e.num_shared) * 3 * d * e.d_expert + d * e.num_experts
            ffn = moe_frac * moe_ffn + (1 - moe_frac) * 3 * d * self.d_ff
        else:
            ffn = 3 * d * self.d_ff
        if self.rglru is not None:
            pat = self.rglru.block_pattern
            fr_attn = sum(1 for p in _pattern_for(self) if p == "attn") / L
            rec = 3 * d * self.rglru.d_rnn + 2 * self.rglru.d_rnn
            per = fr_attn * attn + (1 - fr_attn) * rec + 3 * d * self.d_ff
            return int(emb + L * per)
        return int(emb + L * (attn + ffn))

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        e = self.moe
        n_moe_layers = L // e.moe_every
        full = self.param_count()
        all_experts = n_moe_layers * (e.num_experts + e.num_shared) * 3 * d * e.d_expert
        active = n_moe_layers * (e.top_k + e.num_shared) * 3 * d * e.d_expert
        return int(full - all_experts + active)

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


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def supports_shape(arch: ArchConfig, shape: ShapeConfig) -> bool:
    """long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k":
        return arch.sub_quadratic
    return True
