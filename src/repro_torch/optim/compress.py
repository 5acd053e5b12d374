"""int8 codes of a gradient: symmetric per-tensor quantization.

Counterpart of `quantize_int8` and `dequantize_int8` of
`repro.optim.compress`: q = round(g / s) clipped to [-127, 127], s =
max|g| / 127 (at least 1e-30), ties to even as `jnp.round`; and the
cross-pod reduction built on them, `compressed_psum` and
`make_crosspod_mean`: a gradient tree averaged over the ranks of one mesh
axis (``pod``) with int8 codes, one float32 scale a tensor maxed over the
axis first so the codes are commensurable, the codes summed in int32 (no
overflow below 2^23 / 127 ranks), the sum times the scale over the axis's
size, cast back to each leaf's dtype. The collectives are `core.comm`'s
on ``mesh.get_group(axis)``; the JAX package runs the same arithmetic
under `shard_map`.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import pytree
from repro_torch.core import comm


def quantize_int8(g: torch.Tensor):
    """(codes int8, scale float32 0-dim) of ``g``."""
    gf = g.to(torch.float32)
    scale = torch.clamp(gf.abs().max() / 127.0, min=1e-30)
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(grads, group):
    """The mean over ``group``'s ranks of every leaf of ``grads`` (a tree
    of tensors), through int8 codes summed in int32."""
    n = dist.get_world_size(group)

    def one(g):
        gf = g.to(torch.float32)
        scale = comm.all_reduce_max(
            torch.clamp(gf.abs().max() / 127.0, min=1e-30), group)
        q = torch.clamp(torch.round(gf / scale), -127, 127)
        total = comm.all_reduce_sum(q.to(torch.int32), group)
        return (total.to(torch.float32) * scale / n).to(g.dtype)

    return pytree.tree_map(one, grads)


def make_crosspod_mean(mesh, axis: str = "pod"):
    """fn(grads) -> grads averaged over ``mesh``'s ``axis`` with int8
    payloads (the in-pod reduction, at full precision, is the train
    step's)."""
    group = mesh.get_group(axis)
    return lambda grads: compressed_psum(grads, group)
