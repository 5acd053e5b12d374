"""llama3.2-3b [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256 — small llama3 [hf:meta-llama/Llama-3.2-3B].

SwiGLU, RoPE theta 500k, tied embeddings. n_heads=24 is not divisible by the
16-way model axis: baseline uses the replicated-attention path (DESIGN.md §5)
— a recorded hillclimb lever.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128_256,
    act="swiglu",
    rope_theta=500_000.0,
    tie_embeddings=True,
)
