#!/usr/bin/env python3
"""Sharded LM training on the CUDA cards: four ranks on a (data=2,
model=2) mesh.

    python3 tools/lm_mesh_check.py            # from the repository root
    python3 tools/lm_mesh_check.py --phase    # chip_smoke.py's [lm-mesh]

Builds the attention kernels, then, on four cards (one rank a card, NCCL):

- (e) llama3.2-3b at full width and depth, B=4 x 4096, AdamW on the
  launcher's schedule, 3 steps through `launch.train.train_loop` with the
  sharded step, held to the single-card step from the same seed (rank 0
  runs it first, in bf16 and float32) within `chip_smoke.py`'s [lm-mesh]
  (a) limits, with its step time, tokens/s, peak memory, collectives and
  one traced step's device time split;
- (f) minitron-8b at full width and depth, a layout one card cannot hold
  (its bf16 parameters, float32 AdamW moments and bf16 gradients are 92.8
  GB): first its layout at 2 layers, B=4 x 1024, held to the single-card
  step as (e) is, so that the loss below reads the model and not the
  sharding; then 3 steps of AdamW at a constant 1e-5 on one fixed batch
  of B=4 x 4096, peak memory a card beside the reckoning of its blocks,
  and the loss finite and falling at every step. (AdamW's first update moves every
  weight by lr along its gradient's sign; at 1e-3 and 1e-4 that sent the
  loss of this 4096-wide, 32-layer stack of random weights from 13.0 to
  33.4 and 31.0 on an H100, as 1e-3 does to a 1024-wide, 4-layer one.)

``--phase`` runs `chip_smoke.py`'s `[lm-mesh]` phase alone instead, on
the cards there are (four ranks sharing one card over gloo on a machine
with one). Prints the card's name and power limit. Exits 1 on the first
failed check.
"""
from __future__ import annotations

import argparse
import math
import os
import pathlib
import sys
import tempfile
import time

# (e)'s float32 reference step holds 64 GB of state beside its
# activations on one card: let the allocator grow segments in place
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

# (e): the float32 reference in 4 microbatches of one row (its
# activations beside 64 GB of float32 parameters, moments and gradients)
FULL_LLAMA = dict(arch=cs.LM_ARCH, layers=None, batch=4, seq=4096, steps=3,
                  ref_accum=4)
BIG = dict(arch="minitron-8b", batch=4, seq=4096, steps=3, lr=1e-5)
# (f)'s layout held to one card first: minitron-8b cut to the depth one
# card holds in float32 beside its AdamW state, (a)'s checks and limits
CUT_BIG = dict(arch="minitron-8b", layers=2, batch=4, seq=1024, steps=2)


def reckoned_bytes(cfg, rules) -> dict:
    """Bytes of one rank's blocks, from the spec trees: bf16 parameters,
    float32 AdamW moments (ZeRO-1) and gradients in the parameters'
    dtype, on their reduced blocks."""
    from repro_torch import pytree
    from repro_torch.models import transformer
    from repro_torch.runtime import train
    from repro_torch.sharding import params as sp

    sizes = sp.mesh_axes(rules.mesh)
    shapes = transformer.param_shapes(cfg)
    pspecs = sp.param_specs(cfg, rules, sizes)
    gspecs = train.grad_specs(cfg, rules, "adamw")
    out = {"params": 0, "moments": 0, "grads": 0}
    for path, t in pytree.leaves_with_paths(shapes):
        p = math.prod(sp.local_shape(t.shape, pytree.get(pspecs, path),
                                     sizes))
        g = math.prod(sp.local_shape(t.shape, pytree.get(gspecs, path),
                                     sizes))
        out["params"] += p * t.element_size()
        out["moments"] += 2 * g * 4
        out["grads"] += p * t.element_size()
    return out


def big_rank(plan: dict) -> dict:
    """(f) on one rank: the sharded init of ``plan``'s model at full width
    and depth, ``plan["steps"]`` steps on one fixed batch."""
    import torch.distributed as dist

    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import adamw
    from repro_torch.runtime import train
    from repro_torch.sharding.params import init_sharded_params

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = launch_mesh.rank_device("cuda")
    cfg = launch_train.model_config(plan["arch"])
    mesh = launch_mesh.make_host_mesh(4, ("data", "model"), device=dev)
    rules = launch_mesh.rules_for(mesh)
    t0 = time.perf_counter()
    params = init_sharded_params(cs.SEED, cfg, rules, mesh, device=dev)
    opt = adamw(lr=plan["lr"])
    state = train.init_sharded_train_state(params, opt, cfg, rules)
    step_fn = train.make_train_step(cfg, rules=rules, optimizer=opt)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    after_init = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    data = SyntheticLMData(cfg.vocab_size, plan["seq"], plan["batch"],
                           seed=0)
    batch = launch_train.device_batch(data, 0, cfg, plan["batch"], dev)
    losses, times = [], []
    for _ in range(plan["steps"]):
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    return dict(rank=dist.get_rank(), device=str(dev), losses=losses,
                times=times, init_s=init_s, after_init=after_init,
                peak=torch.cuda.max_memory_allocated(),
                reckoned=reckoned_bytes(cfg, rules) if dist.get_rank() == 0
                else None, backend=dist.get_backend())


def main() -> None:
    ap = argparse.ArgumentParser(prog="python3 tools/lm_mesh_check.py")
    ap.add_argument("--phase", action="store_true",
                    help="chip_smoke.py's [lm-mesh] phase alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this check needs a "
                "CUDA device")
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as launch_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    secs = _build.build(("flash_attn", "flash_attn_bwd"))
    cs.log(f"[build] flash_attn, flash_attn_bwd: {secs:.1f} s; "
           f"{torch.cuda.device_count()} card(s)")
    if args.phase:
        with tempfile.TemporaryDirectory(prefix="lm_mesh_check_") as d:
            cs.phase_lm_mesh(d)
    else:
        if torch.cuda.device_count() < 4:
            cs.fail(f"(e) and (f) need 4 cards, this machine has "
                    f"{torch.cuda.device_count()}")
        tag = "[lm-mesh e]"
        with tempfile.TemporaryDirectory(prefix="lm_mesh_check_") as d:
            cs.phase_lm_mesh(d, FULL_LLAMA, extras=False)
        cs.log(f"{tag} llama3.2-3b full depth B=4 x 4096 on (data=2, "
               f"model=2) == the single-card step within [lm-mesh] (a)'s "
               f"limits")
        tag = "[lm-mesh f]"
        with tempfile.TemporaryDirectory(prefix="lm_mesh_check_") as d:
            cs.phase_lm_mesh(d, CUT_BIG, extras=False)
        cs.log(f"{tag} minitron-8b at {CUT_BIG['layers']} layers, B="
               f"{CUT_BIG['batch']} x {CUT_BIG['seq']}, on (data=2, "
               f"model=2) == the single-card step within [lm-mesh] (a)'s "
               f"limits")
        outs = launch_mesh.spawn(big_rank, 4, "cuda", (BIG,))
        o = outs[0]
        for r in outs:
            cs.check(r["losses"] == o["losses"], f"{tag} ranks disagree")
        rk = o["reckoned"]
        held = ", ".join(f"{r['after_init'] / 2**30:.2f}" for r in outs)
        peaks = ", ".join(f"{r['peak'] / 2**30:.2f}" for r in outs)
        cs.log(f"{tag} {BIG['arch']} full width and depth on 4 cards over "
               f"{o['backend']}, B={BIG['batch']} x {BIG['seq']}, AdamW lr "
               f"{BIG['lr']}: losses {[round(x, 4) for x in o['losses']]}; "
               f"steps "
               f"{[round(t * 1e3, 1) for t in o['times']]} ms (the first "
               f"with warm-up); sharded init {o['init_s']:.1f} s; a card "
               f"holds {held} GiB after init, peak {peaks} GiB; "
               f"reckoned a rank: parameters {rk['params'] / 1e9:.2f} GB + "
               f"AdamW moments {rk['moments'] / 1e9:.2f} GB + gradients "
               f"{rk['grads'] / 1e9:.2f} GB = "
               f"{sum(rk.values()) / 1e9:.2f} GB before activations")
        # memory is read above whatever the losses do: it is what (f) is for
        cs.check(all(np.isfinite(o["losses"]))
                 and all(b < a for a, b in zip(o["losses"], o["losses"][1:])),
                 f"{tag} the loss on a fixed batch is not finite and "
                 f"falling: {o['losses']}")
    cs.log(cs.smi_line())
    cs.log(f"lm_mesh_check: ok ({time.perf_counter() - t_start:.1f} s)")


if __name__ == "__main__":
    main()
