"""DeepSeek-V2-Lite 16B (MLA + MoE).

[arXiv:2405.04434; hf] — 27L, d_model=2048, 16 heads, MLA kv_lora=512,
2 shared + 64 routed experts top-6, expert FFN 1408, vocab 102400.
(The pool line's "160 routed" is full-V2; Lite is 64 routed.)
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="mla_moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    head_dim=128,
    rope_theta=10000.0,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(num_experts=64, num_shared=2, top_k=6, d_expert=1408),
    source="arXiv:2405.04434; hf",
)
