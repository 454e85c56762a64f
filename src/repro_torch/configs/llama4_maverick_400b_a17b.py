"""Llama-4 Maverick 400B-A17B (MoE, early fusion).

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified] — 48L, d_model=5120, 40 heads
(GQA kv=8), expert FFN 8192, vocab 202048, 128 routed experts top-1 + 1 shared, MoE every other layer (interleaved,
as in the released Maverick checkpoints — yields ~400B total / ~17B active).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    rope_theta=500000.0,
    moe=MoEConfig(num_experts=128, num_shared=1, top_k=1, d_expert=8192,
                  moe_every=2),
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
