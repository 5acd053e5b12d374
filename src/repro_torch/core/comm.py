"""Named collectives on one axis of a mesh, counted, and their
differentiable pairs.

Each helper takes the `torch.distributed` group of one mesh axis
(``mesh.get_group(axis)``) and is the counterpart of a JAX collective
over that axis name: `all_gather_cat` is ``all_gather(x, axis,
tiled=True)``, `all_reduce_sum` ``psum``, `all_reduce_max` ``pmax``,
`reduce_scatter_cat` ``psum_scatter(..., tiled=True)`` and
`all_to_all_cat` ``all_to_all(x, axis, split_axis=0, concat_axis=0)``.
Where the JAX package names several axes at once (the expert axes
``("pod", "data")``), the group spans their product, the first axis the
major one (`sharding.spmd.Layout.group`). On a group whose
transport is gloo (ranks sharing a card, `launch.mesh.collective_backend`)
a CUDA tensor goes through a host copy for the collective; NCCL takes it
on the card as it is, and so does the ``fake`` backend of the dry run
(`launch.dryrun`: every tensor stays on its own device, a meta tensor on
meta, and the collective moves nothing). The arithmetic around the
collective stays on the rank's device.

The differentiable pairs are `torch.autograd.Function`s, Megatron's
operators for tensor and sequence parallelism:

- `copy_to_group`: identity forward, `all_reduce` backward (a replicated
  input whose uses on the ranks differ, so each rank's gradient is a
  partial sum);
- `reduce_from_group`: `all_reduce` forward, identity backward (partial
  sums in, the whole value out);
- `gather_along`: `all_gather` along a dim forward, `reduce_scatter`
  backward (the sequence-parallel residual stream into a tensor-parallel
  product; also the ZeRO-3 gather of a parameter over ``data``);
- `reduce_scatter_along`: `reduce_scatter` forward, `all_gather` backward
  (a row-parallel product's partial sums back onto sequence shards);
- `all_to_all_along`: `all_to_all` both ways (the expert-parallel
  dispatch: the exchange is its own transpose);
- `quantized_all_to_all`: the JAX package's int8 dispatch: int8 codes and
  one float32 scale a slot forward, the full-width cotangent backward.

`COLLECTIVES` counts the collectives this process issued by kind,
`COLLECTIVE_BYTES` the bytes each kind handed to the transport (the
tensor a rank contributes: its input to a gather, reduction or
reduce-scatter) and `COLLECTIVE_RESULT_BYTES` the bytes of each kind's
result on the rank (an all-gather's whole output, a reduce-scatter's
block: the convention of the JAX package's ``collective_stats``, which
sums the result shapes of the compiled collectives), backward passes
included.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# torch >= 2.13 names them all_gather_single and reduce_scatter_single
# (the *_tensor names warn)
_gather_single = (getattr(dist, "all_gather_single", None)
                  or dist.all_gather_into_tensor)
_scatter_single = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)

KINDS = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all")
COLLECTIVES = dict.fromkeys(KINDS, 0)
COLLECTIVE_BYTES = dict.fromkeys(KINDS, 0)
COLLECTIVE_RESULT_BYTES = dict.fromkeys(KINDS, 0)


def reset_collectives() -> None:
    for k in KINDS:
        COLLECTIVES[k] = 0
        COLLECTIVE_BYTES[k] = 0
        COLLECTIVE_RESULT_BYTES[k] = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _count(kind: str, t: torch.Tensor, result: torch.Tensor) -> None:
    COLLECTIVES[kind] += 1
    COLLECTIVE_BYTES[kind] += _nbytes(t)
    COLLECTIVE_RESULT_BYTES[kind] += _nbytes(result)


def _comm_device(group, t: torch.Tensor) -> torch.device:
    """Where ``t`` must lie for the group's transport: the current card for
    NCCL, the host for gloo, its own device for the dry run's ``fake``
    backend."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if backend == "fake":
        return t.device
    return torch.device("cpu")


def _wire(group, t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous where the group's transport takes it (gloo: on the
    host); ``t`` itself when it already is, so only a source the
    collective reads goes through here."""
    return t.to(_comm_device(group, t)).contiguous()


def _wire_copy(group, t: torch.Tensor) -> torch.Tensor:
    """As `_wire`, but never ``t`` itself: the buffer of an in-place
    all_reduce."""
    buf = _wire(group, t)
    return buf.clone() if buf.data_ptr() == t.data_ptr() else buf


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order
    (JAX's ``all_gather(x, axis, tiled=True)``)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    src = _wire(group, x.movedim(dim, 0))
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    _gather_single(out, src, group=group)
    _count("all_gather", x, out)
    return out.to(x.device).movedim(0, dim)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum of every rank's ``x`` (JAX's ``psum``)."""
    if dist.get_world_size(group) == 1:
        return x
    buf = _wire_copy(group, x)
    dist.all_reduce(buf, group=group)
    _count("all_reduce", x, x)
    return buf.to(x.device)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of every rank's ``x`` (JAX's ``pmax``)."""
    if dist.get_world_size(group) == 1:
        return x
    buf = _wire_copy(group, x)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
    _count("all_reduce", x, x)
    return buf.to(x.device)


def reduce_scatter_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's ``x``
    (JAX's ``psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``);
    ``x.shape[dim]`` must divide by the group's size."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of size {x.shape[dim]} "
                         f"does not divide over {n} ranks")
    src = _wire(group, x.movedim(dim, 0))
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    _scatter_single(out, src, group=group)
    _count("reduce_scatter", x, out)
    return out.to(x.device).movedim(0, dim)


def all_to_all_cat(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` split into the group's size blocks along dim 0, block j sent
    to group rank j, and the blocks received concatenated along dim 0 in
    group-rank order (JAX's ``all_to_all(x, axis, split_axis=0,
    concat_axis=0, tiled=True)``); ``x.shape[0]`` must divide by the
    group's size."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: dim 0 of size {x.shape[0]} does not "
                         f"divide over {n} ranks")
    src = _wire(group, x)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    _count("all_to_all", x, out)
    return out.to(x.device)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, float32 scales) of ``x`` with one scale for each row
    of its last dim, as the JAX package's `quantized_all_to_all` makes
    them: scale = max(amax, 1e-9) / 127, codes = clip(round(x / scale),
    -127, 127), rounded half to even, by a division."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-9) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all_cat(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_cat(g, ctx.group), None


class _QuantizedAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        q8, scale = quantize_int8(x)
        q8 = all_to_all_cat(q8, group)
        scale = all_to_all_cat(scale, group)
        return (q8.to(torch.float32) * scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_cat(g, ctx.group), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_cat(g, ctx.group, ctx.dim), None, None


class _ReduceScatterAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.group, ctx.dim), None, None


def _trivial(group) -> bool:
    return group is None or dist.get_world_size(group) == 1


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, gradient summed over ``group`` backward."""
    return x if _trivial(group) else _CopyTo.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` forward, identity backward."""
    return x if _trivial(group) else _ReduceFrom.apply(x, group)


def gather_along(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All ranks' ``x`` concatenated along ``dim`` forward; the gradient
    summed over ``group`` and this rank's block kept backward."""
    return x if _trivial(group) else _GatherAlong.apply(x, group, dim)


def all_to_all_along(x: torch.Tensor, group) -> torch.Tensor:
    """`all_to_all_cat` forward and backward (its own transpose)."""
    return x if _trivial(group) else _AllToAll.apply(x, group)


def quantized_all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """`all_to_all_cat` of ``x`` with an int8 payload: each rank sends
    `quantize_int8`'s codes and scales and gets back codes times scales in
    ``x``'s dtype; the backward exchanges the full-width cotangent (the JAX
    package's custom VJP). The codes round even on a group of one, as
    the JAX package's do."""
    return _QuantizedAllToAll.apply(x, group)


def reduce_scatter_along(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over ``group`` forward;
    the gradient gathered along ``dim`` backward."""
    return x if _trivial(group) else _ReduceScatterAlong.apply(x, group,
                                                              dim)
