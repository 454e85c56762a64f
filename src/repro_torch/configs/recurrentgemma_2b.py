"""RecurrentGemma-2B (hybrid: RG-LRU + local attention, 2:1).

[arXiv:2402.19427; hf] — 26L, d_model=2560, 10 heads (MQA kv=1), d_ff=7680,
vocab=256000, lru_width=2560, window=2048, pattern (rglru, rglru, attn).
"""
from repro_torch.configs.base import ArchConfig, RGLRUConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    rglru=RGLRUConfig(d_rnn=2560, conv_width=4, window=2048,
                      block_pattern=("rglru", "rglru", "attn")),
    source="arXiv:2402.19427; hf",
)
