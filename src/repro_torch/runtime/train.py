"""Train step factory: loss and gradients, gradient accumulation,
global-norm clipping and the optimizer update.

Counterpart of `repro.runtime.train` on one device. The gradients are
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

The JAX package's ``rules`` (sharding rules of a production mesh) have no
meaning before the port shards the model: `make_train_step` takes only
``rules=None`` (ROADMAP Queue 1 item 13.5).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import pytree
from repro_torch.models import lm
from repro_torch.optim import clip_by_global_norm, get_optimizer


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: dict
    step: torch.Tensor   # 0-dim int32, on the parameters' device


def init_train_state(params: dict, optimizer) -> TrainState:
    dev = pytree.leaves(params)[0].device
    return TrainState(params, optimizer.init(params),
                      torch.zeros((), dtype=torch.int32, device=dev))


def loss_and_grads(cfg, params: dict, batch: dict):
    """(loss, metrics, grads) of `lm.lm_loss` on one batch, detached; grads
    a tree like params, zeros for a leaf the loss does not reach."""
    paths = pytree.leaves_with_paths(params)
    leaves = [t for _, t in paths]
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, metrics = lm.lm_loss(params, cfg, batch)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    grads = pytree.tree_map(lambda t: None, params)
    for (path, t), g in zip(paths, gs):
        pytree.put(grads, path, torch.zeros_like(t) if g is None else g)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(cfg, rules=None, optimizer=None,
                    max_grad_norm: float = 1.0):
    if rules is not None:
        raise NotImplementedError(
            "make_train_step: sharding rules come with the port's sharding "
            "and launch (ROADMAP Queue 1 item 13.5); pass rules=None")
    optimizer = optimizer or get_optimizer(cfg)
    acc_dtype = getattr(torch, cfg.grad_accum_dtype)

    def compute_grads(params, batch):
        n = cfg.grad_accum
        if n <= 1:
            return loss_and_grads(cfg, params, batch)
        b = next(iter(batch.values())).shape[0]
        if b % n:
            raise ValueError(f"train_step: batch {b} is not a multiple of "
                             f"grad_accum={n}")
        loss_sum, acc = None, None
        for i in range(n):
            mb = {k: v[i * (b // n):(i + 1) * (b // n)]
                  for k, v in batch.items()}
            loss, _, grads = loss_and_grads(cfg, params, mb)
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
        loss = loss_sum * inv
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
