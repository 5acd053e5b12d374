"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) expert_ff=32768
vocab=131072, MoE 8 experts top-2 [hf:xai-org/grok-1].

GeLU experts, tanh attention-logit softcap (grok-style). 8 experts < 16-way
model axis: expert d_ff shards over (data, model) = 256-way (DESIGN.md §5).
Adafactor for the same HBM reasons as kimi.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131_072,
    act="gelu",
    attn_softcap=30.0,
    n_experts=8,
    experts_per_token=2,
    moe_d_ff=32768,
    optimizer="adafactor",
    grad_accum=4,
    grad_accum_dtype="bfloat16",
)
