"""End-to-end LM training on the PyTorch/CUDA port: data pipeline ->
train loop -> checkpoint -> simulated crash -> resume.

Trains a small decoder LM (a reduced config of any assigned arch) on the
synthetic corpus, checkpoints every ``--ckpt-every`` steps, then simulates
a crash halfway and resumes from the last checkpoint; the resumed run
equals the uninterrupted one (`train` with ``crash_at=None``). The
counterpart of `examples/lm_train.py`, with its flags and defaults, plus
``--device`` (default ``cuda``; ``--device cpu`` runs the kernels' plain
versions). Its head dim is d_model / 4 (64 at the default width, a head
dim of the attention kernel). ``--ckpt-dir`` (default a new temporary
directory) must hold no checkpoint yet:

    PYTHONPATH=src python examples/torch_lm_train.py --arch llama3.2-3b \
        --steps 60 --d-model 256 --layers 4
"""
import argparse
import math
import os
import tempfile
import time

import torch

from repro_torch import pytree
from repro_torch.configs import get_config, reduced_config
from repro_torch.data import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.optim import adamw, warmup_cosine_schedule
from repro_torch.runtime import checkpoint, train


def model_config(args):
    return reduced_config(
        get_config(args.arch), d_model=args.d_model, n_layers=args.layers,
        d_ff=4 * args.d_model, vocab_size=args.vocab,
        head_dim=args.d_model // 4, loss_chunk=args.batch * args.seq // 4)


def train_run(args, device, crash_at: int | None, ckpt_dir: str,
              log=print) -> float:
    """``args.steps`` steps; with ``crash_at``, the state is dropped after
    that many steps and restored from the last checkpoint, and the loop
    goes on from the restored state's step. Returns the final loss."""
    cfg = model_config(args)
    n_text = args.seq - cfg.prefix_len
    params = transformer.init_params(0, cfg, device=device)
    n_params = sum(t.numel() for t in pytree.leaves(params))
    log(f"arch={args.arch} (reduced) params={n_params / 1e6:.1f}M "
        f"tokens/step={args.batch * n_text} device={device}")
    opt = adamw(schedule=warmup_cosine_schedule(3e-3, 10, args.steps))
    step_fn = train.make_train_step(cfg, optimizer=opt)
    state = train.init_train_state(params, opt)
    data = SyntheticLMData(cfg.vocab_size, n_text, args.batch, seed=7)

    def batch_for(step):
        out = {"tokens": torch.as_tensor(data.batch(step)["tokens"],
                                         device=device)}
        if cfg.prefix_len:
            out["prefix_embed"] = torch.zeros(
                (args.batch, cfg.prefix_len, cfg.d_model), device=device)
        return out

    stop = args.steps if crash_at is None else crash_at
    t0 = time.time()
    metrics = None
    for step in range(stop):
        state, metrics = step_fn(state, batch_for(step))
        if step % args.ckpt_every == 0 or step == stop - 1:
            checkpoint.save_tree(ckpt_dir, step, state)
        if step % 10 == 0:
            log(f"step {step:4d} loss {float(metrics['loss']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.2f} "
                f"({(time.time() - t0) / (step + 1):.2f}s/step)")
    if crash_at is not None:
        log(f"\n!! simulated crash at step {crash_at}; restarting from the "
            f"last checkpoint")
        last = checkpoint.latest_step(ckpt_dir)
        # a fresh state of the same structure (the update works in place,
        # so ``params`` hold the last step's values), its tensors restored
        like = train.init_train_state(
            transformer.init_params(0, cfg, device=device), opt)
        state, restored_step = checkpoint.restore_tree(ckpt_dir, last, like)
        log(f"resumed at step {int(state.step)} (checkpoint "
            f"{restored_step})")
        for step in range(int(state.step), args.steps):
            state, metrics = step_fn(state, batch_for(step))
            if step % 10 == 0:
                log(f"step {step:4d} loss {float(metrics['loss']):.4f}")
    loss = float(metrics["loss"])
    log(f"\nfinal loss {loss:.4f} (started ~{math.log(cfg.vocab_size):.2f});"
        f" total {time.time() - t0:.0f}s")
    return loss


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None,
                    help="where the checkpoints go (default: a new "
                         "temporary directory); it must hold none yet")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    return ap


def main():
    args = parser().parse_args()
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="lm_train_ckpt_")
    if os.path.isdir(ckpt_dir) and checkpoint.latest_step(ckpt_dir) \
            is not None:
        raise SystemExit(f"--ckpt-dir {ckpt_dir} holds checkpoints already")
    train_run(args, resolve_device(args.device), args.steps // 2, ckpt_dir)


if __name__ == "__main__":
    main()
