"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) expert_ff=2048
vocab=163840, MoE 384 experts top-8 — trillion-param MoE [arXiv:2501.kimi2].

~1.03T total / ~30B active parameters. Trains with Adafactor: Adam fp32
states would exceed v5e HBM at 512 chips (DESIGN.md §5). grad_accum=4 keeps
per-microbatch activations bounded and overlaps the grad reduce-scatter.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,           # unused for moe blocks (kept for reference)
    vocab_size=163_840,
    act="swiglu",
    n_experts=384,
    experts_per_token=8,
    moe_d_ff=2048,
    capacity_factor=1.0,   # §Perf: a2a wire bytes scale with C
    moe_a2a_int8=True,     # §Perf: int8 dispatch payload
    optimizer="adafactor",
    grad_accum=4,
    grad_accum_dtype="bfloat16",
)
