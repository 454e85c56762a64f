"""xLSTM-125M (sLSTM + mLSTM blocks).

[arXiv:2405.04517; unverified] — 12L, d_model=768, 4 heads, d_ff=0 (blocks
carry their own projections), vocab=50304; 1 sLSTM per 4 layers.
"""
from repro_torch.configs.base import ArchConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="xlstm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    head_dim=192,
    tie_embeddings=True,
    xlstm=XLSTMConfig(slstm_every=4, mlstm_proj_factor=2.0,
                      slstm_proj_factor=4.0 / 3.0, chunk=256),
    source="arXiv:2405.04517; unverified",
)
