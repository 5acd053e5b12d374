#!/usr/bin/env python3
"""Sharded LM training and serving on the CUDA cards: four ranks on a
(data=2, model=2) mesh, every layer kind.

    python3 tools/lm_mesh_check.py                # (e)-(k), from the root
    python3 tools/lm_mesh_check.py --cases j,k    # some of them
    python3 tools/lm_mesh_check.py --phase        # chip_smoke.py's [lm-mesh]

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
- (g) zamba2-7b at full width (the hybrid: sharded Mamba2 blocks, shared
  attention blocks at head dim 112): first cut to 7 layers (1 super-block
  and 1 tail layer), B=4 x 1024, held to the single-card step as (e) is;
  then at full depth (83.5 GB of state on one card, reckoned), B=4 x
  4096, 3 steps of AdamW at 1e-5 on one fixed batch as (f): step time,
  tokens/s, peak memory a card beside the reckoning, the attention's hd
  112 backward launches, the loss finite and falling;
- (h) grok-1-314b at full width, 2 layers, B=8 x 1024 (4 microbatches:
  a row a data rank each), Adafactor, in both expert-parallel modes:
  "alltoall" (the (2, 2) mesh's own: 8 experts over 2 data ranks) and
  "gathered" (`MeshRules(expert=())`, the layout of grok's 16 data
  ranks). At capacity factor n_experts / experts_per_token no token drops,
  so the cross entropy of the first batch at the initial weights equals
  the single card's within (a)'s limits (rank 0 computes it first, in bf16
  and float32; the aux loss differs by design); then at the config's own
  1.25, 3 steps on one fixed batch at lr 1e-5: step time, collectives and
  bytes by kind, peak memory, the loss finite;
- (i) kimi-k2-1t-a32b at published width, 1 of 61 layers (the state one
  card cannot hold beside its activations), B=8 x 4096, Adafactor at lr
  1e-5, the int8 dispatch: 3 steps on one fixed batch, the loss finite and
  falling, step time, tokens/s, peak memory a card, and the all-to-all's
  bytes a step beside their reckoning from the dispatch buffer's shape.

- (j) sharded serving (`lm_serve.generate(rules=)`: prefill, then
  context-parallel decode) of llama3.2-3b at full width and depth, a B=4
  x 4096 prompt, 32 greedy tokens, against one card's generate from the
  same seed (rank 0 runs it first): the agreement of the tokens, the
  first flipped position, the prefill logits' bf16 row error; prefill
  and decode ms, one traced decode step's device time and idle share,
  collectives a decode step, peak memory a card;
- (k) grok-1-314b "alltoall" served sharded: at 8 layers, B=4 x 1024, at
  a capacity with no drops, against one card's generate as (j); then at
  24 layers (~160 GB of bf16 weights reckoned, ~40 GB a card: past what
  one card holds), B=4 x 4096, 32 tokens at the config's capacity, the
  weights drawn a layer at a time: prefill and decode ms, a traced decode
  step, collectives, peak memory.

``--phase`` runs `chip_smoke.py`'s `[lm-mesh]` phase alone instead, on
the cards there are (four ranks sharing one card over gloo on a machine
with one). Prints the card's name and power limit. Exits 1 on the first
failed check.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import pathlib
import statistics
import sys
import tempfile
import time
import types

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
# (g): the hybrid's layout on one card first (1 super-block, 1 tail layer),
# then at full depth
CUT_ZAMBA = dict(arch="zamba2-7b", layers=7, batch=4, seq=1024, steps=2)
BIG_ZAMBA = dict(arch="zamba2-7b", batch=4, seq=4096, steps=3, lr=1e-5)
# (h), (i): the MoE at full width, Adafactor at a constant lr on one fixed
# batch. Adafactor's first update moves every weight by about lr along its
# gradient's sign: at 1e-4 that sent grok's loss from 12.25 to 23.97 on an
# H100, as AdamW's does to minitron-8b in (f); 1e-5 as there. (h) reads
# time and traffic, so only its loss's finiteness is checked; (i) also
# checks that the loss falls
GROK = dict(arch="grok-1-314b", layers=2, batch=8, seq=1024, steps=3,
            lr=1e-5, modes=("alltoall", "gathered"), no_drop=True,
            falls=False)
KIMI = dict(arch="kimi-k2-1t-a32b", layers=1, batch=8, seq=4096, steps=3,
            lr=1e-5, modes=("alltoall",), no_drop=False, falls=True)
# (j): sharded serving of llama3.2-3b at full depth, held to one card's
# generate (rank 0 runs it first); s_max leaves room for the timed steps
SERVE_LLAMA = dict(arch=cs.LM_ARCH, layers=None, batch=4, prompt=4096,
                   s_max=4160, tokens=32, trace=True)
# (k): grok-1-314b "alltoall", first at 8 layers beside one card's
# generate at a capacity with no drops (a prompt of 1024: one card holds
# the 56.2 GB of weights beside the no-drop dispatch buffers), then 24
# layers (~160 GB of bf16, ~40 GB a card: no one card holds it) at the
# config's own capacity, drawn a layer at a time
SERVE_GROK_CUT = dict(arch="grok-1-314b", layers=8, batch=4, prompt=1024,
                      s_max=1088, tokens=32, no_drop=True)
SERVE_GROK_DEEP = dict(arch="grok-1-314b", layers=24, batch=4, prompt=4096,
                       s_max=4160, tokens=32, reference=False, layered=True,
                       trace=True)


def reckoned_bytes(cfg, rules, optimizer_name: str = "adamw") -> dict:
    """Bytes of one rank's blocks, from the spec trees: parameters in the
    config's dtype, float32 optimizer moments (AdamW's two on their
    ZeRO-1 blocks; Adafactor's factored row and column means) and
    gradients in the parameters' dtype, on their reduced blocks."""
    from repro_torch import pytree
    from repro_torch.models import transformer
    from repro_torch.runtime import train
    from repro_torch.sharding import params as sp

    sizes = sp.mesh_axes(rules.mesh)
    shapes = transformer.param_shapes(cfg)
    pspecs = sp.param_specs(cfg, rules, sizes)
    gspecs = train.grad_specs(cfg, rules, optimizer_name)
    out = {"params": 0, "moments": 0, "grads": 0}
    for path, t in pytree.leaves_with_paths(shapes):
        spec = pytree.get(pspecs, path)
        p = math.prod(sp.local_shape(t.shape, spec, sizes))
        out["params"] += p * t.element_size()
        out["grads"] += p * t.element_size()
        if optimizer_name == "adamw":
            g = math.prod(sp.local_shape(t.shape, pytree.get(gspecs, path),
                                         sizes))
            out["moments"] += 2 * g * 4
        elif len(t.shape) >= 2:
            out["moments"] += 4 * (
                math.prod(sp.local_shape(t.shape[:-1], spec[:-1], sizes))
                + math.prod(sp.local_shape(t.shape[:-2] + t.shape[-1:],
                                           spec[:-2] + spec[-1:], sizes)))
        else:
            out["moments"] += 4 * p
    return out


def big_rank(plan: dict) -> dict:
    """(f), (g) on one rank: the sharded init of ``plan``'s model at full
    width and depth, ``plan["steps"]`` AdamW steps at ``plan["lr"]`` on one
    fixed batch, the attention's launches counted."""
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import adamw
    from repro_torch.runtime import train
    from repro_torch.sharding.params import init_sharded_params

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = launch_mesh.rank_device(plan.get("device", "cuda"))
    cfg = launch_train.model_config(plan["arch"], plan.get("reduced", False))
    mesh = launch_mesh.make_host_mesh(4, ("data", "model"), device=dev)
    rules = launch_mesh.rules_for(mesh)
    t0 = time.perf_counter()
    params = init_sharded_params(cs.SEED, cfg, rules, mesh, device=dev)
    opt = adamw(lr=plan["lr"])
    state = train.init_sharded_train_state(params, opt, cfg, rules)
    step_fn = train.make_train_step(cfg, rules=rules, optimizer=opt)
    cs._on(dev, torch.cuda.synchronize)
    init_s = time.perf_counter() - t0
    after_init = cs._on(dev, torch.cuda.memory_allocated, 0)
    cs._on(dev, torch.cuda.reset_peak_memory_stats)
    data = SyntheticLMData(cfg.vocab_size, plan["seq"], plan["batch"],
                           seed=0)
    batch = launch_train.device_batch(data, 0, cfg, plan["batch"], dev)
    losses, times = [], []
    kernels.reset_launch_counts()
    for _ in range(plan["steps"]):
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        cs._on(dev, torch.cuda.synchronize)
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    return dict(rank=dist.get_rank(), device=str(dev), losses=losses,
                times=times, init_s=init_s, after_init=after_init,
                peak=cs._on(dev, torch.cuda.max_memory_allocated, 0),
                counts=kernels.launch_counts(),
                reckoned=reckoned_bytes(cfg, rules) if dist.get_rank() == 0
                else None, backend=dist.get_backend())


def check_big(tag: str, plan: dict, outs: list) -> None:
    """(f), (g)'s readings and checks from the ranks' results: the ranks
    agree, the loss on the fixed batch is finite and falls at every
    step."""
    o = outs[0]
    for r in outs:
        cs.check(r["losses"] == o["losses"], f"{tag} ranks disagree")
    rk = o["reckoned"]
    held = ", ".join(f"{r['after_init'] / 2**30:.2f}" for r in outs)
    peaks = ", ".join(f"{r['peak'] / 2**30:.2f}" for r in outs)
    tokens = plan["batch"] * plan["seq"]
    steady = statistics.median(o["times"][1:])
    cs.log(f"{tag} {plan['arch']} full width and depth on 4 cards over "
           f"{o['backend']}, B={plan['batch']} x {plan['seq']}, AdamW lr "
           f"{plan['lr']}: losses {[round(x, 4) for x in o['losses']]}; "
           f"steps {[round(t * 1e3, 1) for t in o['times']]} ms (the first "
           f"with warm-up), steady {steady * 1e3:.1f} ms = "
           f"{tokens / steady:.0f} tokens/s; sharded init "
           f"{o['init_s']:.1f} s; a card holds {held} GiB after init, peak "
           f"{peaks} GiB; reckoned a rank: parameters "
           f"{rk['params'] / 1e9:.2f} GB + AdamW moments "
           f"{rk['moments'] / 1e9:.2f} GB + gradients "
           f"{rk['grads'] / 1e9:.2f} GB = {sum(rk.values()) / 1e9:.2f} GB "
           f"before activations; attention launches a rank "
           f"{o['counts']['flash_attention']} forward, "
           f"{o['counts'][cs.FLASH_BWD]} backward")
    # memory is read above whatever the losses do: it is what (f) is for
    cs.check(all(np.isfinite(o["losses"]))
             and all(b < a for a, b in zip(o["losses"], o["losses"][1:])),
             f"{tag} the loss on a fixed batch is not finite and falling: "
             f"{o['losses']}")


def _sharded_ce(cfg, rules, params, batch) -> float:
    """The cross entropy of ``batch`` (the global one) at the rank's
    blocks ``params``, forward only: each rank's rows, the shares summed
    over the batch axes."""
    from repro_torch.core import comm
    from repro_torch.models import lm
    from repro_torch.sharding import params as sp

    mesh = rules.mesh
    local = {k: sp.shard(v, sp.batch_specs(cfg, rules, mesh, {k: v})[k],
                         mesh) for k, v in batch.items()}
    with torch.no_grad():
        ce = lm.lm_loss(params, cfg, local, rules=rules)[1]["ce_loss"]
        for a in rules.batch:
            ce = comm.all_reduce_sum(ce, mesh.get_group(a))
    return float(ce)


def _one_card_ce(cfg, batch, dev) -> dict:
    """The single-card cross entropy of ``batch`` at the initial weights
    from cs.SEED, forward only, in the config's dtype (A) and in float32
    (B): A and |A - B|, the spread of (a)'s limits."""
    from repro_torch.models import lm, transformer

    ce = {}
    for name, dtype in (("A", None), ("B", torch.float32)):
        c = cfg if dtype is None else dataclasses.replace(cfg,
                                                          dtype="float32")
        params = transformer.init_params(cs.SEED, c, dtype=dtype,
                                         device=dev)
        with torch.no_grad():
            ce[name] = float(lm.lm_loss(params, c, batch)[1]["ce_loss"])
        del params
        cs._on(dev, torch.cuda.empty_cache)
    return dict(ce=ce["A"], spread=abs(ce["A"] - ce["B"]))


def a2a_reckoning(cfg, rules, plan: dict) -> int:
    """The bytes a rank hands to the all-to-all in one step, from the
    dispatch buffer's shape: for each microbatch, forward twice (the layer
    is rematerialised) the dispatch (int8 codes and a float32 scale a slot
    when ``moe_a2a_int8``, else the model dtype) and the return (the model
    dtype: partial sums are not quantized), backward both in the model
    dtype; (dp, E/dp, C, D) each, C = `moe._capacity` of the rank's tokens
    (its rows of a microbatch, the sequence gathered over ``model``)."""
    from repro_torch.models import moe
    from repro_torch.sharding import params as sp

    sizes = sp.mesh_axes(rules.mesh)
    n = max(cfg.grad_accum, 1)
    dp = math.prod(sizes[a] for a in rules.batch)
    t = plan["batch"] // n // dp * plan["seq"]
    slots = cfg.n_experts * moe._capacity(cfg, t)
    wide = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    send = slots * (cfg.d_model + 4) if cfg.moe_a2a_int8 else \
        slots * cfg.d_model * wide
    back = slots * cfg.d_model * wide
    forwards = 2 if cfg.remat else 1
    return cfg.n_layers * n * (forwards * (send + back) + 2 * back)


def moe_rank(plan: dict) -> dict:
    """(h), (i) on one rank: for each of ``plan["modes"]``, the sharded init
    of ``plan``'s model, with ``plan["no_drop"]`` the cross entropy of the
    first batch at capacity factor n_experts / experts_per_token (rank 0
    computes the single card's first, `_one_card_ce`), then
    ``plan["steps"]`` Adafactor steps at ``plan["lr"]`` on that batch at
    the config's own capacity: losses, times, collectives and bytes a
    step, peak memory."""
    import torch.distributed as dist

    from repro_torch.core import comm
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import train as launch_train
    from repro_torch.models.moe import _ep_mode
    from repro_torch.optim import adafactor
    from repro_torch.runtime import train
    from repro_torch.sharding.params import init_sharded_params

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = launch_mesh.rank_device(plan.get("device", "cuda"))
    cfg = launch_train.model_config(plan["arch"], plan.get("reduced", False),
                                    plan["layers"])
    mesh = launch_mesh.make_host_mesh(4, ("data", "model"), device=dev)
    base = launch_mesh.rules_for(mesh)
    data = SyntheticLMData(cfg.vocab_size, plan["seq"], plan["batch"],
                           seed=0)
    batch = launch_train.device_batch(data, 0, cfg, plan["batch"], dev)
    no_drop = dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    out = dict(rank=dist.get_rank(), device=str(dev),
               backend=dist.get_backend(), modes={})
    if plan["no_drop"] and out["rank"] == 0:
        out["one"] = _one_card_ce(no_drop, batch, dev)
    for mode in plan["modes"]:
        rules = base if mode == "alltoall" else \
            dataclasses.replace(base, expert=())
        cs.check(_ep_mode(cfg, rules) == mode, f"{plan['arch']}: the rules "
                 f"give {_ep_mode(cfg, rules)}, not {mode}")
        t0 = time.perf_counter()
        params = init_sharded_params(cs.SEED, cfg, rules, mesh, device=dev)
        cs._on(dev, torch.cuda.synchronize)
        res = dict(init_s=time.perf_counter() - t0,
                   after_init=cs._on(dev, torch.cuda.memory_allocated, 0),
                   reckoned=reckoned_bytes(cfg, rules, "adafactor"),
                   a2a_reckoned=a2a_reckoning(cfg, rules, plan)
                   if mode == "alltoall" else 0)
        if plan["no_drop"]:
            res["ce"] = _sharded_ce(no_drop, rules, params, batch)
        opt = adafactor(lr=plan["lr"])
        state = train.init_sharded_train_state(params, opt, cfg, rules)
        step_fn = train.make_train_step(cfg, rules=rules, optimizer=opt)
        cs._on(dev, torch.cuda.reset_peak_memory_stats)
        losses, times, coll = [], [], []
        for _ in range(plan["steps"]):
            comm.reset_collectives()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            cs._on(dev, torch.cuda.synchronize)
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            coll.append((dict(comm.COLLECTIVES),
                         dict(comm.COLLECTIVE_BYTES)))
        res.update(losses=losses, times=times, coll=coll,
                   peak=cs._on(dev, torch.cuda.max_memory_allocated, 0))
        out["modes"][mode] = res
        del state, step_fn, params, opt
        cs._on(dev, torch.cuda.empty_cache)
    return out


def check_moe(tag: str, plan: dict, outs: list) -> None:
    """(h), (i)'s readings and checks: the ranks agree; with
    ``no_drop`` the sharded cross entropy == the single card's within 4x
    its bf16-to-float32 spread (at least 1e-6 of it); the loss on the
    fixed batch finite, and falling where ``plan["falls"]``."""
    o = outs[0]
    tokens = plan["batch"] * plan["seq"]
    for mode, res in o["modes"].items():
        for r in outs:
            cs.check(r["modes"][mode]["losses"] == res["losses"],
                     f"{tag} {mode}: the ranks disagree")
        if plan["no_drop"]:
            one = o["one"]
            limit = max(cs.LM_MESH_SAFETY * one["spread"], 1e-6 * one["ce"])
            cs.check(abs(res["ce"] - one["ce"]) <= limit,
                     f"{tag} {mode}: the first batch's cross entropy "
                     f"{res['ce']} sharded, {one['ce']} on one card (limit "
                     f"{limit:.3g})")
            cs.log(f"{tag} {mode}: capacity factor {plan['arch']}'s "
                   f"n_experts / experts_per_token (no token drops): cross "
                   f"entropy of the first batch {res['ce']:.6f} sharded / "
                   f"{one['ce']:.6f} one card (limit {limit:.3g}: "
                   f"{cs.LM_MESH_SAFETY} x the bf16-to-float32 spread "
                   f"{one['spread']:.3g})")
        steady = statistics.median(res["times"][1:])
        coll, nbytes = res["coll"][-1]
        rk = res["reckoned"]
        peaks = ", ".join(f"{r['modes'][mode]['peak'] / 2**30:.2f}"
                          for r in outs)
        held = ", ".join(f"{r['modes'][mode]['after_init'] / 2**30:.2f}"
                         for r in outs)
        cs.log(f"{tag} {mode}: {plan['arch']} {plan['layers']} layer(s), "
               f"B={plan['batch']} x {plan['seq']}, Adafactor lr "
               f"{plan['lr']} on one fixed batch: losses "
               f"{[round(x, 4) for x in res['losses']]}; steps "
               f"{[round(t * 1e3, 1) for t in res['times']]} ms (the first "
               f"with warm-up), steady {steady * 1e3:.1f} ms = "
               f"{tokens / steady:.0f} tokens/s; sharded init "
               f"{res['init_s']:.1f} s; a card holds {held} GiB after init, "
               f"peak {peaks} GiB; reckoned a rank: parameters "
               f"{rk['params'] / 1e9:.2f} GB + Adafactor moments "
               f"{rk['moments'] / 1e9:.3f} GB + gradients "
               f"{rk['grads'] / 1e9:.2f} GB; collectives a step on rank 0: "
               + ", ".join(f"{coll[k]} {k} ({nbytes[k] / 1e6:.1f} MB)"
                           for k in coll))
        if res["a2a_reckoned"]:
            got = nbytes["all_to_all"]
            cs.log(f"{tag} {mode}: the all-to-all a step on rank 0 "
                   f"{got / 1e6:.1f} MB, reckoned {res['a2a_reckoned'] / 1e6:.1f}"
                   f" MB from the dispatch buffer's shape")
            cs.check(got == res["a2a_reckoned"], f"{tag} {mode}: the "
                     f"all-to-all moved {got} bytes a step, not the "
                     f"reckoned {res['a2a_reckoned']}")
        falling = all(b < a for a, b in zip(res["losses"],
                                            res["losses"][1:]))
        cs.check(all(np.isfinite(res["losses"]))
                 and (falling or not plan["falls"]),
                 f"{tag} {mode}: the loss on a fixed batch is not finite"
                 f"{' and falling' if plan['falls'] else ''}: "
                 f"{res['losses']}")


def case_e() -> None:
    with tempfile.TemporaryDirectory(prefix="lm_mesh_check_") as d:
        cs.phase_lm_mesh(d, (FULL_LLAMA,), extras=False)
    cs.log("[lm-mesh e] llama3.2-3b full depth B=4 x 4096 on (data=2, "
           "model=2) == the single-card step within [lm-mesh] (a)'s limits")


def _cut_then_big(tag: str, cut: dict, big: dict) -> None:
    from repro_torch.launch import mesh as launch_mesh

    with tempfile.TemporaryDirectory(prefix="lm_mesh_check_") as d:
        cs.phase_lm_mesh(d, (cut,), extras=False)
    cs.log(f"{tag} {cut['arch']} at {cut['layers']} layers, B="
           f"{cut['batch']} x {cut['seq']}, on (data=2, model=2) == the "
           f"single-card step within [lm-mesh] (a)'s limits")
    check_big(tag, big, launch_mesh.spawn(big_rank, 4, "cuda", (big,)))


def case_f() -> None:
    _cut_then_big("[lm-mesh f]", CUT_BIG, BIG)


def case_g() -> None:
    _cut_then_big("[lm-mesh g]", CUT_ZAMBA, BIG_ZAMBA)


def _moe_case(tag: str, plan: dict) -> None:
    from repro_torch.launch import mesh as launch_mesh

    check_moe(tag, plan, launch_mesh.spawn(moe_rank, 4, "cuda", (plan,)))


def case_h() -> None:
    _moe_case("[lm-mesh h]", GROK)


def case_i() -> None:
    _moe_case("[lm-mesh i]", KIMI)


def layered_params(plan: dict, mesh, dev) -> dict:
    """This rank's blocks of ``plan``'s model (`cs.serve_config`), drawn a
    layer at a time: layer l is `init_sharded_params` of a one-layer
    config from seed SEED + l, copied into the stacked blocks (the
    embedding, final norm and head from layer 0's draw). A stacked expert
    weight drawn whole (`init_sharded_params`) would not fit one card at
    grok-1-314b's 24 layers (wi alone: 77.3 GB in bf16). Also returns the
    bytes the rank holds before the first layer and after each."""
    from repro_torch import pytree
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import transformer
    from repro_torch.sharding import params as sp

    cfg = cs.serve_config(plan)
    rules = launch_mesh.rules_for(mesh)
    sizes = sp.mesh_axes(mesh)
    specs = sp.param_specs(cfg, rules, sizes)
    out = pytree.tree_map(lambda t: None, transformer.param_shapes(cfg))
    for path, t in pytree.leaves_with_paths(transformer.param_shapes(cfg)):
        pytree.put(out, path, torch.empty(
            sp.local_shape(t.shape, pytree.get(specs, path), sizes),
            dtype=t.dtype, device=dev))
    one = dataclasses.replace(cfg, n_layers=1)
    held = [cs._on(dev, torch.cuda.memory_allocated, 0)]
    for layer in range(cfg.n_layers):
        part = sp.init_sharded_params(cs.SEED + layer, one, rules, mesh,
                                      device=dev)
        for path, t in pytree.leaves_with_paths(part):
            if path[0] == "layers":
                pytree.get(out, path)[layer].copy_(t[0])
            elif layer == 0:
                pytree.get(out, path).copy_(t)
        del part, t
        cs._on(dev, torch.cuda.empty_cache)
        held.append(cs._on(dev, torch.cuda.memory_allocated, 0))
        if layer % 8 == 0:      # progress, readable if a later draw fails
            print(f"[layered] rank {mesh.get_rank()}: layer {layer} drawn, "
                  f"{held[-1] / 2**30:.2f} GiB held", flush=True)
    return out, held


def serve_rank(plan: dict) -> dict:
    """(j), (k) on one rank: ``plan`` served sharded (`cs._lm_mesh_e_full`),
    its parameters drawn a layer at a time where ``plan["layered"]``
    (`layered_params`)."""
    from repro_torch.launch import mesh as launch_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = launch_mesh.rank_device(plan.get("device", "cuda"))
    mesh = launch_mesh.make_host_mesh(4, ("data", "model"), device=dev)
    params, held = None, None
    if plan.get("layered"):
        params, held = layered_params(plan, mesh, dev)
    out = cs._lm_mesh_e_full(plan, mesh, dev, params)
    out["layered_held"] = held
    return out


def reckon_serve(plan: dict) -> dict:
    """The bytes of a rank's parameter blocks and of its KV caches for
    ``plan`` on the (2, 2) mesh, from the spec trees (and of the whole
    parameters, one card's)."""
    from repro_torch import pytree
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import transformer
    from repro_torch.sharding import params as sp

    cfg = cs.serve_config(plan)
    sizes = {"data": 2, "model": 2}
    rules = launch_mesh.rules_for(types.SimpleNamespace(shape=sizes))
    specs = sp.param_specs(cfg, rules, sizes)
    whole = rank = 0
    for path, t in pytree.leaves_with_paths(transformer.param_shapes(cfg)):
        n = t.element_size()
        whole += t.numel() * n
        rank += math.prod(sp.local_shape(t.shape, pytree.get(specs, path),
                                         sizes)) * n
    slots = (plan["batch"] // 2) * (plan["s_max"] // 2)    # a rank's
    kv = 2 * cfg.n_layers * slots * cfg.n_kv_heads * cfg.head_dim * 2
    return dict(whole=whole, rank=rank, kv=kv)


def _serve_case(tag: str, plans: tuple) -> None:
    from repro_torch.launch import mesh as launch_mesh

    for plan in plans:
        rk = reckon_serve(plan)
        cs.log(f"{tag} {plan['arch']} at {plan['layers'] or 'all'} layers, "
               f"reckoned: parameters {rk['whole'] / 1e9:.2f} GB on one "
               f"card, {rk['rank'] / 1e9:.2f} GB a rank's blocks on (data=2,"
               f" model=2); KV caches {rk['kv'] / 1e9:.3f} GB a rank")
    for plan in plans:      # a spawn each: the next starts on empty cards
        outs = launch_mesh.spawn(serve_rank, 4, "cuda", (plan,))
        held = outs[0]["layered_held"]
        if held:
            cs.log(f"{tag} rank 0 holds {held[0] / 2**30:.2f} GiB of empty "
                   f"blocks, then after each layer's draw "
                   f"{[round(b / 2**30, 2) for b in held[1:]]} GiB")
        cs.check_serve_full(tag, plan, outs)


def case_j() -> None:
    _serve_case("[lm-mesh j]", (SERVE_LLAMA,))


def case_k() -> None:
    _serve_case("[lm-mesh k]", (SERVE_GROK_CUT, SERVE_GROK_DEEP))


CASES = {"e": case_e, "f": case_f, "g": case_g, "h": case_h, "i": case_i,
         "j": case_j, "k": case_k}


def main() -> None:
    ap = argparse.ArgumentParser(prog="python3 tools/lm_mesh_check.py")
    ap.add_argument("--phase", action="store_true",
                    help="chip_smoke.py's [lm-mesh] phase alone")
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated cases of the four-card run "
                         "(default: all of e to k)")
    args = ap.parse_args()
    cases = args.cases.split(",")
    if not set(cases) <= set(CASES):
        ap.error(f"--cases: {args.cases!r}; the cases are {sorted(CASES)}")
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this check needs a "
                "CUDA device")
    from repro_torch.kernels import _build

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
            cs.fail(f"({', '.join(cases)}) need 4 cards, this machine has "
                    f"{torch.cuda.device_count()}")
        for case in cases:
            t0 = time.perf_counter()
            CASES[case]()
            cs.log(f"[lm-mesh {case}] {time.perf_counter() - t0:.1f} s")
    cs.log(cs.smi_line())
    cs.log(f"lm_mesh_check: ok ({time.perf_counter() - t_start:.1f} s)")


if __name__ == "__main__":
    main()
