"""musicgen-large [audio]: 48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Backbone only per assignment: the EnCodec frontend is a stub providing frame
embeddings; the 4-codebook delay pattern is flattened to one token stream
(DESIGN.md §8). Standard pre-LN transformer, GELU MLP, LayerNorm.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    act="gelu",
    norm="layer",
    frontend="audio_frames",
)
