"""Training launcher: random-init LM, synthetic data, checkpointed loop.

Counterpart of `repro.launch.train` on one device:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --reduced --steps 20 --ckpt-dir /tmp/run1 --device cpu

The same flags and log lines ("step N loss X (T s/step)" every 5 steps,
"resumed from checkpoint step N", "done: ..."), plus ``--device`` (default
``cuda``: without a card it raises `CudaUnavailableError` unless given
``--device cpu``) and ``--layers`` (a cut of the published config's depth,
every width as published). The model is `transformer.init_params` from
seed 0, the optimizer the config's (AdamW or Adafactor) on a warmup-cosine
schedule (peak 1e-3, 10 warmup steps, ``--steps`` in all), the data
`SyntheticLMData` with seed 0; a checkpoint (`checkpoint.save_tree`, the
JAX package's keys) is written after every step that is a multiple of
``--ckpt-every`` and after the last.

A resume continues from the restored state's own step, the one after the
checkpointed step, so a run resumed from ``--ckpt-dir`` equals the
uninterrupted run. (The JAX launcher restarts at the checkpoint's label,
the step it already took, and takes that step twice.)

``--production-mesh`` trains on the 16x16 (data, model) mesh, one rank a
card, under torchrun with 256 ranks (``torchrun --nproc-per-node 8
--nnodes 32 ... -m repro_torch.launch.train --production-mesh``):
`launch.mesh.rules_for` its rules, each rank's shards of the same
parameters (`sharding.params.init_sharded_params`), the sharded step
(`runtime.train.make_train_step(rules=...)`), and the same loop, log
lines (the writer's) and checkpoints (gathered by `checkpoint.save_tree`,
restored by cutting). On a group of any other size it exits with status
2 and one line naming the 256 ranks it needs. The global batch must
divide over the 16 data ranks.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.data import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import transformer
from repro_torch.optim import get_optimizer, warmup_cosine_schedule
from repro_torch.runtime import checkpoint, train
from repro_torch.sharding import params as sharding_params


def model_config(arch: str, reduced: bool = False,
                 layers: int | None = None):
    """The config of ``arch``: reduced for the CPU, or with its depth cut
    to ``layers``."""
    cfg = get_config(arch)
    if reduced:
        cfg = reduced_config(cfg)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def optimizer_for(cfg, steps: int):
    """The config's optimizer on the launcher's schedule for ``steps``."""
    return get_optimizer(cfg, schedule=warmup_cosine_schedule(1e-3, 10,
                                                              steps))


def build(cfg, *, steps: int, device, seed: int = 0):
    """(state, step_fn): fresh parameters from ``seed`` on ``device``, the
    config's optimizer on the launcher's schedule, its train step."""
    params = transformer.init_params(seed, cfg, device=device)
    opt = optimizer_for(cfg, steps)
    return (train.init_train_state(params, opt),
            train.make_train_step(cfg, optimizer=opt))


def build_sharded(cfg, rules, *, steps: int, device, seed: int = 0):
    """`build` on a rank of ``rules.mesh``: this rank's shards of the
    parameters `build` draws from ``seed``, the optimizer's state for
    them, the sharded train step."""
    from repro_torch.sharding.params import init_sharded_params

    params = init_sharded_params(seed, cfg, rules, rules.mesh, device=device)
    opt = optimizer_for(cfg, steps)
    return (train.init_sharded_train_state(params, opt, cfg, rules),
            train.make_train_step(cfg, rules=rules, optimizer=opt))


def device_batch(data: SyntheticLMData, step: int, cfg, batch: int,
                 device) -> dict:
    """Step ``step``'s tokens on ``device``, with the vlm's zero prefix."""
    out = {"tokens": torch.as_tensor(data.batch(step)["tokens"],
                                     device=device)}
    if cfg.prefix_len:
        out["prefix_embed"] = torch.zeros(
            (batch, cfg.prefix_len, cfg.d_model), dtype=torch.float32,
            device=device)
    return out


def train_loop(state, step_fn, data, cfg, *, start: int, steps: int,
               batch: int, device, ckpt_dir: str | None = None,
               ckpt_every: int = 50, log=print, on_step=None, specs=None,
               mesh=None):
    """Steps ``start`` .. ``steps`` - 1; returns (state, the last step's
    metrics or None). ``on_step(step, metrics)`` runs after each step.
    With ``ckpt_dir``, a checkpoint every ``ckpt_every`` steps and after
    the last step run (once: a step is never saved twice, which
    `checkpoint.save_tree` refuses).
    A sharded state (a rank's blocks) comes with its spec tree ``specs``
    and ``mesh``, which the checkpoints gather it by."""
    t0 = time.time()
    metrics = None
    for step in range(start, steps):
        state, metrics = step_fn(
            state, device_batch(data, step, cfg, batch, device))
        if ckpt_dir and step % ckpt_every == 0:
            checkpoint.save_tree(ckpt_dir, step, state, specs=specs,
                                 mesh=mesh)
        if on_step is not None:
            on_step(step, metrics)
        if step % 5 == 0:
            log(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                f"({(time.time() - t0) / max(step - start + 1, 1):.2f} "
                f"s/step)")
    if ckpt_dir and steps > start and (steps - 1) % ckpt_every:
        checkpoint.save_tree(ckpt_dir, steps - 1, state, specs=specs,
                             mesh=mesh)
    return state, metrics


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="gemma-2b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 (data, model) mesh: 256 ranks under "
                         "torchrun, one a card")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers (a cut "
                         "of the published config; every width as "
                         "published)")
    args = ap.parse_args(argv)
    specs = mesh = None
    if args.production_mesh:
        launch_mesh.join_group(args.device)
        try:
            mesh = launch_mesh.make_production_mesh(device=args.device)
        except ValueError as e:
            print(f"--production-mesh: {e} (start 256 ranks, one a card, "
                  f"with torchrun)", file=sys.stderr)
            return 2
    dev = resolve_device(args.device)
    cfg = model_config(args.arch, args.reduced, args.layers)
    if mesh is not None:
        rules = launch_mesh.rules_for(mesh)
        dev = launch_mesh.rank_device(dev)
        state, step_fn = build_sharded(cfg, rules, steps=args.steps,
                                       device=dev)
        specs = sharding_params.train_state_specs(
            cfg, rules, sharding_params.mesh_axes(mesh), cfg.optimizer)
    else:
        state, step_fn = build(cfg, steps=args.steps, device=dev)
    say = print if launch_mesh.is_writer() else (lambda *a, **k: None)

    start = 0
    if args.ckpt_dir and (last := checkpoint.latest_step(args.ckpt_dir)) \
            is not None:
        state, _ = checkpoint.restore_tree(args.ckpt_dir, last, state,
                                           specs=specs, mesh=mesh)
        start = int(state.step)
        say(f"resumed from checkpoint step {last}")

    n_text = args.seq - cfg.prefix_len
    data = SyntheticLMData(cfg.vocab_size, n_text, args.batch, seed=0)
    state, metrics = train_loop(
        state, step_fn, data, cfg, start=start, steps=args.steps,
        batch=args.batch, device=dev, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, log=lambda m: say(m, flush=True),
        specs=specs, mesh=mesh)
    final = "" if metrics is None else \
        f", final loss {float(metrics['loss']):.4f}"
    say(f"done: {max(args.steps - start, 0)} steps{final}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
