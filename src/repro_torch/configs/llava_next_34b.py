"""LLaVA-NeXT 34B (VLM backbone; anyres tiling frontend is a stub).

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] — 60L, d_model=7168,
56 heads (kv=8), d_ff=20480, vocab=64000.  `input_specs` provides precomputed
patch embeddings (B, n_frontend_tokens, d_model).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    rope_theta=5000000.0,
    n_frontend_tokens=576,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)
