"""Shared model pieces: norms, RoPE, activations, init helpers.

Counterpart of `repro.models.common`. Parameters are drawn from an explicit
`torch.Generator` (float32 draws, then cast), which cannot replay the JAX
package's `jax.random` streams: the tests carry JAX's parameters across
with `repro_torch.convert.lm_params_from_arrays`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def normal_init(gen: torch.Generator, shape, std: float,
                dtype: torch.dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * std).to(dtype)


# ---------------------------------------------------------------------------
# norms — computed in f32, cast back to input dtype
# ---------------------------------------------------------------------------

def init_norm(cfg, dtype: torch.dtype, device, lead=()) -> dict:
    """Norm parameters, with leading axes ``lead`` (the layer stack)."""
    shape = (*lead, cfg.d_model)
    p = {"w": torch.zeros(shape, dtype=dtype, device=device)
         if cfg.norm == "rms1p"
         else torch.ones(shape, dtype=dtype, device=device)}
    if cfg.norm == "layer":
        p["b"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


def apply_norm(p: dict, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "layer":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * p["w"].to(torch.float32) + p["b"].to(torch.float32)
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps)
        w = p["w"].to(torch.float32)
        out = out * (1.0 + w) if kind == "rms1p" else out * w
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, H, hd); positions (..., S) integer."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_frequencies(hd, theta), dtype=torch.float32,
                            device=x.device)
    # (..., S, hd/2)
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., :, None, :]   # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def activation(name: str):
    if name in ("swiglu", "silu"):
        return F.silu
    if name in ("geglu", "gelu"):
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


def is_glu(name: str) -> bool:
    return name in ("swiglu", "geglu")
