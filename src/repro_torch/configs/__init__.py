"""Architecture registry, a copy of `repro.configs`: one module per
assigned architecture. `get_config(name)` selects one; `reduced_config`
makes the small same-family config the CPU tests use."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES, shapes_for

ARCH_IDS = [
    "musicgen-large",
    "paligemma-3b",
    "mamba2-1.3b",
    "llama3.2-3b",
    "gemma-2b",
    "minitron-8b",
    "command-r-35b",
    "kimi-k2-1t-a32b",
    "grok-1-314b",
    "zamba2-7b",
]

_MODULE_FOR = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[name]}")
    return mod.CONFIG


def reduced_config(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Small same-family config for CPU smoke tests."""
    small = dict(
        n_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        loss_chunk=64,
    )
    if cfg.n_heads:
        small.update(n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2))
    if cfg.family == "moe":
        small.update(n_experts=4, experts_per_token=2, moe_d_ff=64)
    if cfg.family in ("ssm", "hybrid"):
        small.update(ssm_state=16, ssm_head_dim=16)
    if cfg.family == "hybrid":
        small.update(n_layers=6, shared_attn_every=3, n_shared_blocks=2)
    if cfg.prefix_len:
        small.update(prefix_len=8)
    small.update(dtype="float32", grad_accum=1)
    if cfg.n_experts:
        small.update(moe_a2a_int8=False)  # smoke tests stay bit-deterministic
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


__all__ = [
    "ArchConfig", "ShapeConfig", "SHAPES", "ARCH_IDS",
    "get_config", "reduced_config", "shapes_for",
]
