"""mamba2-1.3b [ssm]: 48L d_model=2048 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060].

Pure Mamba2: expand=2 (d_inner=4096), head_dim=64 (64 SSD heads), conv=4,
single B/C group. Vocab padded 50280 -> 50304 for TP divisibility.
Sub-quadratic: runs the long_500k shape.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50_280,
    tie_embeddings=True,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
)
