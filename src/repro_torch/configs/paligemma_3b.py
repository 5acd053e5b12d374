"""paligemma-3b [vlm]: 18L d_model=2048 8H (GQA kv=1) d_ff=16384
vocab=257216 — SigLIP + gemma [arXiv:2407.07726; hf].

Gemma-2b text backbone with a 256-position SigLIP patch-embedding prefix
(frontend is a stub per assignment). MQA (kv=1), GeGLU, head_dim 256,
gemma-style (1+w) RMSNorm and sqrt(d) embedding scaling.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257_216,
    act="geglu",
    norm="rms1p",
    embed_scale=True,
    frontend="vision_patches",
    prefix_len=256,
)
