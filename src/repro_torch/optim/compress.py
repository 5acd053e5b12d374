"""int8 codes of a gradient: symmetric per-tensor quantization.

Counterpart of `quantize_int8` and `dequantize_int8` of
`repro.optim.compress`: q = round(g / s) clipped to [-127, 127], s =
max|g| / 127 (at least 1e-30), ties to even as `jnp.round`. The cross-pod
reduction built on them (`compressed_psum`, `make_crosspod_mean`, a
collective over a `pod` mesh axis) comes with sharding and launch.
"""
from __future__ import annotations

import torch


def quantize_int8(g: torch.Tensor):
    """(codes int8, scale float32 0-dim) of ``g``."""
    gf = g.to(torch.float32)
    scale = torch.clamp(gf.abs().max() / 127.0, min=1e-30)
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
