"""Dense LM MLP blocks: SwiGLU / GeGLU / GELU / squared-ReLU.

Counterpart of `repro.models.lm_mlp` on one device (no sharding).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import activation, is_glu, normal_init


def init_mlp(gen: torch.Generator, cfg, dtype: torch.dtype, lead=()) -> dict:
    """MLP weights, with leading axes ``lead`` (the layer stack)."""
    d, ff = cfg.d_model, cfg.d_ff
    p = {
        "wi": normal_init(gen, (*lead, d, ff), d ** -0.5, dtype),
        "wo": normal_init(gen, (*lead, ff, d), ff ** -0.5, dtype),
    }
    if is_glu(cfg.act):
        p["wg"] = normal_init(gen, (*lead, d, ff), d ** -0.5, dtype)
    return p


def mlp_block(params: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    act = activation(cfg.act)
    h = x @ params["wi"]
    if is_glu(cfg.act):
        h = act(x @ params["wg"]) * h
    else:
        h = act(h)
    return h @ params["wo"]
