"""Optimizers as (init, update) pairs on trees of tensors, updated in place.

Counterpart of `repro.optim.optimizers`: AdamW with float32 first and
second moments, Adafactor with the second moment factored over the two
trailing dims of every >= 2-D parameter, global-norm clipping and the
warmup-cosine schedule, with the JAX package's signatures (`update(grads,
state, params, step) -> (params, state)`, step a 0-dim int32 tensor).

Each element's float32 arithmetic follows the JAX package's expressions in
their order (a product of three factors left to right, every operation
rounded on its own), and sums over leaves take the JAX package's leaf
order (`pytree.leaves_with_paths`: dict keys sorted). A Python float meets
a float32 tensor as float32, as a weak-typed scalar does in JAX; a Python
number divided by a tensor goes through `torch.div`, since `float /
tensor` would take the reciprocal and multiply.

Where the JAX update is functional, this one works in place, which is
what lets llama3.2-3b's AdamW fit one card: params and the state's
tensors are updated leaf by leaf, each gradient is overwritten and its
reference in ``grads`` dropped once applied (update consumes ``grads``),
and at most two float32 temporaries of one leaf live at a time. `update`
returns the same ``params`` and ``state`` objects.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch import pytree

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, step) -> (params, state)
    name: str = ""


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as float32: the tensor itself if it is one, else a copy."""
    return t if t.dtype == F32 else t.to(F32)


def _global_sums(sums: list, specs: list, mesh) -> list:
    """Each leaf's sum of squares over the whole leaf, from this rank's
    block's ``sums``: summed over every axis its spec shards it on, and
    counted once over the others (rank 0 of the axis alone adds it)."""
    from repro_torch.core import comm
    from repro_torch.sharding.params import spec_axes

    vec = torch.stack(sums)
    used = [spec_axes(s) for s in specs]
    for axis in sorted(set().union(*used)):
        own = torch.tensor([axis in u for u in used], device=vec.device)
        first = mesh.get_local_rank(axis) == 0
        vec = comm.all_reduce_sum(
            torch.where(own | first, vec, torch.zeros_like(vec)),
            mesh.get_group(axis))
    return list(vec.unbind())


def clip_by_global_norm(grads, max_norm: float, specs=None, mesh=None):
    """Scale every leaf of ``grads`` in place by min(1, max_norm / max(gnorm,
    1e-9)); returns (grads, gnorm). gnorm is the square root of the
    per-leaf float32 sums of squares added in the JAX package's leaf order;
    a bfloat16 leaf is scaled in float32 and rounded back, as JAX's
    `(g.astype(f32) * scale).astype(g.dtype)`. With ``specs`` (a spec tree
    like ``grads``) and ``mesh``, ``grads`` are a rank's blocks: each
    leaf's sum is taken over the whole leaf (`_global_sums`) before the
    leaves are added in that order, so every rank gets the same gnorm."""
    leaves = pytree.leaves(grads)
    sums = [torch.sum(torch.square(_f32(g))) for g in leaves]
    if specs is not None:
        sums = _global_sums(sums, [pytree.get(specs, p) for p, _ in
                                   pytree.leaves_with_paths(grads)], mesh)
    total = None
    for s in sums:
        total = s if total is None else total + s
    gnorm = torch.sqrt(total)
    limit = torch.full_like(gnorm, max_norm)
    scale = torch.clamp(torch.div(limit, torch.clamp(gnorm, min=1e-9)),
                        max=1.0)
    for g in leaves:
        if g.dtype == F32:
            g.mul_(scale)
        else:
            g.copy_(g.to(F32) * scale)
    return grads, gnorm


def warmup_cosine_schedule(peak_lr: float, warmup: int, total: int,
                           floor: float = 0.1):
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(F32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


def _constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=F32, device=step.device)


def _take(grads, path):
    """The gradient at ``path``, its reference in ``grads`` dropped."""
    g = pytree.get(grads, path)
    pytree.put(grads, path, None)
    return g


def _apply(p: torch.Tensor, delta: torch.Tensor, lr_t: torch.Tensor,
           tmp: torch.Tensor) -> None:
    """p = (p.f32 - lr_t * delta).astype(p.dtype), in place; ``delta`` and
    ``tmp`` are float32 scratch of p's shape."""
    delta.mul_(lr_t)
    if p.dtype == F32:
        p.sub_(delta)
    else:
        tmp.copy_(p)
        tmp.sub_(delta)
        p.copy_(tmp)


def adamw(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01,
          schedule=None):
    lr_fn = schedule or _constant(lr)

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=F32, device=p.device)
        return {"m": pytree.tree_map(zeros, params),
                "v": pytree.tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        stepf = step.to(F32) + 1.0
        lr_t = lr_fn(step)
        bc1 = 1 - torch.pow(b1, stepf)
        bc2 = 1 - torch.pow(b2, stepf)
        for path, p in pytree.leaves_with_paths(params):
            m = pytree.get(state["m"], path)
            v = pytree.get(state["v"], path)
            gf = _f32(_take(grads, path))
            # m = b1 * m + (1 - b1) * gf
            tmp = gf * (1 - b1)
            m.mul_(b1).add_(tmp)
            # v = b2 * v + (1 - b2) * gf * gf
            torch.mul(gf, 1 - b2, out=tmp)
            tmp.mul_(gf)
            v.mul_(b2).add_(tmp)
            # delta = (m / bc1) / (sqrt(v / bc2) + eps) + wd * p
            torch.div(v, bc2, out=tmp)
            tmp.sqrt_().add_(eps)
            torch.div(m, bc1, out=gf)
            gf.div_(tmp)
            if weight_decay:
                tmp.copy_(p)
                tmp.mul_(weight_decay)
                gf.add_(tmp)
            _apply(p, gf, lr_t, tmp)
            del gf, tmp
        return params, state

    return Optimizer(init, update, "adamw")


def adafactor(lr=1e-2, decay=0.8, eps=1e-30, clip_threshold=1.0,
              weight_decay=0.0, schedule=None):
    lr_fn = schedule or _constant(lr)

    def init(params):
        def state_for(p):
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=F32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=F32, device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=F32, device=p.device)}
        return pytree.tree_map(state_for, params)

    @torch.no_grad()
    def update(grads, state, params, step, groups=None):
        """``groups``: for a rank's blocks, a tree like ``params`` giving
        for each dim the process groups of the axes it is sharded on; the
        row and column means and the RMS of the update then sum over
        them (`_mean`)."""
        stepf = step.to(F32) + 1.0
        beta = 1.0 - torch.pow(stepf, -decay)
        lr_t = lr_fn(step)
        for path, p in pytree.leaves_with_paths(params):
            s = pytree.get(state, path)
            dims = () if groups is None else pytree.get(groups, path)
            gf = _f32(_take(grads, path))
            # g2 = gf * gf + eps
            g2 = gf * gf
            g2.add_(eps)
            if p.dim() >= 2:
                # vr = beta * vr + (1 - beta) * mean(g2, -1); vc over -2
                s["vr"].mul_(beta).add_((1 - beta) * _mean(g2, -1, dims))
                s["vc"].mul_(beta).add_((1 - beta) * _mean(g2, -2, dims))
                vr = s["vr"][..., None]
                row = vr / torch.clamp(_mean(vr, -2, dims, keepdim=True),
                                       min=eps)
                # upd = gf * rsqrt(max(row * vc, eps))
                torch.mul(row, s["vc"][..., None, :], out=g2)
            else:
                s["v"].mul_(beta).add_((1 - beta) * g2)
                g2.copy_(s["v"])
            g2.clamp_(min=eps).rsqrt_()
            gf.mul_(g2)
            # update clipping: upd / max(1, sqrt(mean(upd^2) + 1e-30) / clip)
            torch.mul(gf, gf, out=g2)
            rms = torch.sqrt(_mean(g2, None, dims) + 1e-30)
            gf.div_(torch.clamp(rms / clip_threshold, min=1.0))
            if weight_decay:
                g2.copy_(p)
                g2.mul_(weight_decay)
                gf.add_(g2)
            _apply(p, gf, lr_t, g2)
            del gf, g2
        return params, state

    return Optimizer(init, update, "adafactor")


def _mean(x: torch.Tensor, dim, dims: tuple,
          keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dim)`` (every dim when None) of a whole tensor whose block
    ``x`` is: ``dims[d]`` the process groups dim d is sharded over (empty
    on one device, where this is ``x.mean``). A sharded mean is the local
    sum, summed over the groups, over the whole size."""
    from repro_torch.core import comm

    over = range(x.dim()) if dim is None else [dim % x.dim()]
    grps = [g for d in over if d < len(dims) for g in dims[d]]
    if not grps:
        return x.mean() if dim is None else x.mean(dim, keepdim=keepdim)
    total = x.sum() if dim is None else x.sum(dim, keepdim=keepdim)
    n = x.numel() if dim is None else x.shape[dim]
    for g in grps:
        total = comm.all_reduce_sum(total, g)
        n *= dist.get_world_size(g)
    return total / n


def get_optimizer(cfg, schedule=None) -> Optimizer:
    if cfg.optimizer == "adafactor":
        return adafactor(schedule=schedule)
    return adamw(schedule=schedule)
