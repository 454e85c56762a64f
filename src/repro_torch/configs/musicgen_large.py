"""MusicGen-large (decoder-only over EnCodec tokens; 4 codebooks).

[arXiv:2306.05284; hf] — 48L, d_model=2048, 32 heads (kv=32), d_ff=8192,
vocab=2048 per codebook; delay-pattern / text conditioning are frontend stubs.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    norm="layernorm",
    n_codebooks=4,
    source="arXiv:2306.05284; hf",
)
