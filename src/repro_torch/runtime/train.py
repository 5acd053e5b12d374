"""Train step factory: loss and gradients, gradient accumulation,
global-norm clipping and the optimizer update.

Counterpart of `repro.runtime.train`. The gradients are
`torch.autograd.grad` of `models.lm.lm_loss` with respect to every
parameter leaf; with `cfg.grad_accum` = n > 1 the batch splits into n
microbatches along its first axis, their gradients are summed in
`cfg.grad_accum_dtype` (the first cast, then each added in that dtype) and
scaled by 1/n, and the metrics are those the JAX package returns then:
``ce_loss`` (the mean of the microbatches' full losses, under the JAX
package's name), ``loss`` and ``grad_norm``. The update works in place
(`repro_torch.optim`): the state's tensors are the ones passed in, and the
state a step returns shares them with the one it was given, whose step
alone is left as it was.

With ``rules`` (`sharding.rules.MeshRules` bound to the `DeviceMesh` of
the ranks, `launch.mesh.rules_for`) the step is the JAX package's sharded
step as explicit SPMD, for every layer kind (`attn_mlp`, `ssm` and the
hybrid, `attn_moe` in both expert-parallel modes; `sharding.spmd`). The
state is this rank's blocks (`init_sharded_train_state`,
`sharding.params.shard_tree`) and the step takes the global batch, every
rank the same: each microbatch of it (the JAX package's, rows i*B/n to
(i+1)*B/n) is cut over the batch axes (`sharding.params.batch_specs`; it
must divide), and the forward is `transformer.forward_train(...,
rules=)`. Then the gradients are reduced over the batch axes, a leaf at a
time: nothing more over an axis the leaf is sharded on (a ZeRO-3
leaf: its gather's backward reduce-scattered it; an expert weight on the
expert axes: every rank's tokens reached its owner), a `reduce_scatter` onto the rank's block for a leaf
whose AdamW moments are ZeRO-1-sharded, an `all_reduce` otherwise. The
global norm sums every leaf's block over the axes it is sharded on
(`optim.clip_by_global_norm`'s sharded form), and the update runs on
blocks: AdamW on the rank's ZeRO-1 block of each parameter, which is then
gathered over ``data``; Adafactor with its row and column means and its
RMS clip reduced over the sharded dims.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import pytree
from repro_torch.core import comm
from repro_torch.models import lm
from repro_torch.optim import clip_by_global_norm, get_optimizer
from repro_torch.sharding import params as sp
from repro_torch.sharding.spmd import layout


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: dict
    step: torch.Tensor   # 0-dim int32, on the parameters' device


def init_train_state(params: dict, optimizer) -> TrainState:
    dev = pytree.leaves(params)[0].device
    return TrainState(params, optimizer.init(params),
                      torch.zeros((), dtype=torch.int32, device=dev))


def loss_and_grads(cfg, params: dict, batch: dict, rules=None):
    """(loss, metrics, grads) of `lm.lm_loss` on one batch, detached; grads
    a tree like params, zeros for a leaf the loss does not reach."""
    paths = pytree.leaves_with_paths(params)
    leaves = [t for _, t in paths]
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, metrics = lm.lm_loss(params, cfg, batch, rules=rules)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    grads = pytree.tree_map(lambda t: None, params)
    for (path, t), g in zip(paths, gs):
        pytree.put(grads, path, torch.zeros_like(t) if g is None else g)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _accumulate(cfg, microbatches, grads_of):
    """(loss, grads, metrics of the last microbatch): ``grads_of(mb)``'s
    gradients summed over the microbatches in `cfg.grad_accum_dtype`, each
    dropped once added, the sum and the loss scaled by 1/n; one
    microbatch's as they come (in the parameters' dtypes), as the JAX
    package takes them without accumulation."""
    if len(microbatches) == 1:
        loss, metrics, grads = grads_of(microbatches[0])
        return loss, grads, metrics
    acc_dtype = getattr(torch, cfg.grad_accum_dtype)
    n = len(microbatches)
    loss_sum, acc, metrics = None, None, None
    for mb in microbatches:
        loss, metrics, grads = grads_of(mb)
        loss_sum = loss if loss_sum is None else loss_sum + loss
        if acc is None:
            acc = pytree.tree_map(lambda g: g.to(acc_dtype), grads)
            continue
        with torch.no_grad():
            for path, a in pytree.leaves_with_paths(acc):
                a.add_(pytree.get(grads, path).to(acc_dtype))
                pytree.put(grads, path, None)
    inv = 1.0 / n
    with torch.no_grad():
        for g in pytree.leaves(acc):
            g.mul_(torch.tensor(inv, dtype=acc_dtype))
    return loss_sum * inv, acc, metrics


def _microbatches(cfg, batch: dict) -> list:
    n = max(cfg.grad_accum, 1)
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"train_step: batch {b} is not a multiple of "
                         f"grad_accum={n}")
    return [{k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
            for i in range(n)]


def make_train_step(cfg, rules=None, optimizer=None,
                    max_grad_norm: float = 1.0):
    optimizer = optimizer or get_optimizer(cfg)
    if rules is not None:
        return _make_sharded_train_step(cfg, rules, optimizer,
                                        max_grad_norm)

    def compute_grads(params, batch):
        if cfg.grad_accum <= 1:
            return loss_and_grads(cfg, params, batch)
        loss, acc, _ = _accumulate(
            cfg, _microbatches(cfg, batch),
            lambda mb: loss_and_grads(cfg, params, mb))
        return loss, {"ce_loss": loss}, acc

    def train_step(state: TrainState, batch: dict):
        loss, metrics, grads = compute_grads(state.params, batch)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        params, opt_state = optimizer.update(grads, state.opt_state,
                                             state.params, state.step)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return TrainState(params, opt_state, state.step + 1), metrics

    return train_step


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

def grad_specs(cfg, rules, optimizer_name: str) -> dict:
    """The spec tree of the reduced gradients (and the optimizer's block
    of each parameter): AdamW's moment specs (the parameter's plus
    ZeRO-1), the parameter specs for Adafactor."""
    ms = sp.mesh_axes(rules.mesh)
    if optimizer_name == "adamw":
        return sp.opt_state_specs(cfg, rules, ms, "adamw")["m"]
    return sp.param_specs(cfg, rules, ms)


def _zero1_dims(pspec: tuple, gspec: tuple) -> list:
    """[(dim, axis)] where the gradient spec shards a dim the parameter's
    does not (ZeRO-1)."""
    out = []
    for dim, (pe, ge) in enumerate(zip(pspec, gspec)):
        for a in sp.entry_axes(ge):
            if a not in sp.entry_axes(pe):
                out.append((dim, a))
    return out


def zero1_views(params: dict, pspecs: dict, gspecs: dict, mesh) -> dict:
    """A tree of views of ``params``: each leaf's block under its gradient
    spec (its ZeRO-1 block over ``data``; the leaf itself where the spec
    adds nothing)."""
    out = pytree.tree_map(lambda t: None, params)
    for path, p in pytree.leaves_with_paths(params):
        for dim, a in _zero1_dims(pytree.get(pspecs, path),
                                  pytree.get(gspecs, path)):
            i, n = sp._block(mesh, (a,))
            p = p.narrow(dim, i * (p.shape[dim] // n), p.shape[dim] // n)
        pytree.put(out, path, p)
    return out


def init_sharded_train_state(params: dict, optimizer, cfg,
                             rules) -> TrainState:
    """`init_train_state` for this rank's blocks ``params``: the
    optimizer's state for its blocks (AdamW's moments on the ZeRO-1 blocks
    of `grad_specs`), step 0."""
    pspecs = sp.param_specs(cfg, rules, sp.mesh_axes(rules.mesh))
    views = zero1_views(params, pspecs,
                        grad_specs(cfg, rules, optimizer.name), rules.mesh)
    dev = pytree.leaves(params)[0].device
    return TrainState(params, optimizer.init(views),
                      torch.zeros((), dtype=torch.int32, device=dev))


def make_sharded_grads(cfg, rules, optimizer_name: str):
    """fn(params, batch) -> (loss, metrics, grads): the sharded step's
    gradients, before clipping. ``params`` are this rank's blocks and
    ``batch`` the global batch; each microbatch's rows are cut over the
    batch axes, the gradients accumulated as on one device and reduced
    over the batch axes onto their `grad_specs` blocks (after the last
    microbatch; each microbatch's before its rounding to a narrower
    accumulation dtype), and the loss and ce_loss summed over the batch
    axes (the whole batch's)."""
    lay = layout(cfg, rules)
    mesh = rules.mesh
    pspecs, gspecs = lay.specs, grad_specs(cfg, rules, optimizer_name)
    n_batch = math.prod(sp.mesh_axes(mesh)[a] for a in rules.batch)

    def local(mb: dict) -> dict:
        out = {}
        for k, v in mb.items():
            if v.shape[0] % n_batch:
                raise ValueError(
                    f"the sharded train step cuts each microbatch over the "
                    f"batch axes {rules.batch} ({n_batch} ranks); {k} has "
                    f"{v.shape[0]} rows")
            out[k] = sp.shard(v, sp.batch_specs(cfg, rules, mesh, {k: v})[k],
                              mesh)
        return out

    def reduce(grads):
        for path, g in pytree.leaves_with_paths(grads):
            pspec, gspec = pytree.get(pspecs, path), pytree.get(gspecs, path)
            zero = {a: d for d, a in _zero1_dims(pspec, gspec)}
            for a in rules.batch:
                if a in sp.spec_axes(pspec):
                    continue        # ZeRO-3 or an expert axis: complete
                group = mesh.get_group(a)
                g = (comm.reduce_scatter_cat(g, group, zero[a]) if a in zero
                     else comm.all_reduce_sum(g, group))
            pytree.put(grads, path, g)
        return grads

    # with an accumulation dtype narrower than float32 each microbatch's
    # gradients are reduced over the batch axes before they are rounded
    # to it, as the JAX package's microbatch scan adds the whole (reduced)
    # gradient of each; a float32 sum is reduced once, after the last
    per_mb = cfg.grad_accum > 1 and \
        torch.finfo(getattr(torch, cfg.grad_accum_dtype)).bits < 32

    def one(params, mb):
        loss, metrics, grads = loss_and_grads(cfg, params, local(mb), rules)
        if per_mb:
            with torch.no_grad():
                grads = reduce(grads)
        return loss, metrics, grads

    def grads_of(params, batch):
        mbs = _microbatches(cfg, batch)
        loss, grads, metrics = _accumulate(cfg, mbs,
                                           lambda mb: one(params, mb))
        ce = metrics["ce_loss"]
        with torch.no_grad():
            for group in lay.batch_groups:
                loss = comm.all_reduce_sum(loss, group)
                ce = comm.all_reduce_sum(ce, group)
            if not per_mb:
                grads = reduce(grads)
        metrics = {"ce_loss": loss} if len(mbs) > 1 else \
            dict(metrics, ce_loss=ce)
        return loss, metrics, grads

    return grads_of


def _make_sharded_train_step(cfg, rules, optimizer, max_grad_norm: float):

    grads_of = make_sharded_grads(cfg, rules, optimizer.name)  # checks cfg
    mesh = rules.mesh
    pspecs = layout(cfg, rules).specs
    gspecs = grad_specs(cfg, rules, optimizer.name)
    # Adafactor's means: the groups of the axes each dim is sharded on
    groups = sp._map_specs(lambda s: tuple(
        tuple(mesh.get_group(a) for a in sp.entry_axes(e)) for e in s),
        pspecs) if optimizer.name == "adafactor" else None

    def train_step(state: TrainState, batch: dict):
        loss, metrics, grads = grads_of(state.params, batch)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm,
                                               specs=gspecs, mesh=mesh)
        if groups is not None:
            optimizer.update(grads, state.opt_state, state.params,
                             state.step, groups=groups)
        else:
            views = zero1_views(state.params, pspecs, gspecs, mesh)
            optimizer.update(grads, state.opt_state, views, state.step)
            with torch.no_grad():
                for path, p in pytree.leaves_with_paths(state.params):
                    for dim, a in _zero1_dims(pytree.get(pspecs, path),
                                              pytree.get(gspecs, path)):
                        p.copy_(comm.all_gather_cat(
                            pytree.get(views, path), mesh.get_group(a),
                            dim))
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return TrainState(state.params, state.opt_state,
                          state.step + 1), metrics

    return train_step
