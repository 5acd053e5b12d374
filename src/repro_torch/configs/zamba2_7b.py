"""zamba2-7b [hybrid]: 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks [arXiv:2411.15242].

81 Mamba2 layers with 2 *shared* attention+MLP blocks invoked every 6 layers
(alternating), per the Zamba2 scheme (per-invocation LoRA deltas omitted —
DESIGN.md §8). Sub-quadratic backbone: runs the long_500k shape (the shared
attention blocks carry real 500k KV caches — the honest cost).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32_000,
    act="swiglu",
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    shared_attn_every=6,
    n_shared_blocks=2,
)
