"""Dense LM MLP blocks: SwiGLU / GeGLU / GELU / squared-ReLU.

Counterpart of `repro.models.lm_mlp`: `mlp_block` on one device,
`mlp_block_sharded` on a rank of a mesh (`sharding.spmd`): ``wi`` and
``wg`` column-parallel, ``wo`` row-parallel over ``model``.
"""
from __future__ import annotations

import torch

from repro_torch.core import comm
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


def mlp_block_sharded(params: dict, cfg, z: torch.Tensor, lay,
                      specs: dict, seq_sharded: bool = True) -> torch.Tensor:
    """``z`` (B, S/tp, D) this rank's sequence block; gathered along the
    sequence into the rank's d_ff columns, and the row-parallel product's
    partial sums reduce-scattered back: (B, S/tp, D). Without
    ``seq_sharded`` (decode), ``z`` is the whole (B, 1, D), the same on
    every model rank, and the partial sums are all-reduced over
    ``model``."""
    w = {k: lay.weight(params[k], specs[k]) for k in params}
    if not seq_sharded:
        return comm.reduce_from_group(mlp_block(w, cfg, z), lay.model_group)
    zf = comm.gather_along(z, lay.model_group, 1)
    y = mlp_block(w, cfg, zf)
    return comm.reduce_scatter_along(y, lay.model_group, 1)
