"""The port's sharded LM train step for the `ssm`, hybrid and `attn_moe`
layer kinds on a (data=2, model=2) mesh of 4 gloo ranks on the CPU, held
to the JAX package's jitted SHARDED step on a (data=2, model=2) mesh of 4
host devices.

The reference is JAX's sharded step, not its unsharded one: an MoE rank
routes its own tokens at its own capacity and the aux loss is the mean of
the ranks' local losses (the JAX package's `_moe_ep`), so the MoE's
sharded step differs from one device's by design
(`test_moe_sharded_step_differs_from_one_device`). The JAX side runs in a
subprocess (``XLA_FLAGS`` must be set before JAX initialises, and another
test file in this worker may have imported it already): it writes the
initial states first (`transformer.init_params(PRNGKey(0))`), which the
port's ranks take through `convert.train_state_from_arrays(...,
rules=)` while it compiles and runs its steps, then its steps' metrics,
parameters and optimizer states (two subprocesses at once, the SSM cases
and the MoE ones). One group of 4 ranks is spawned once, on one
intra-op thread each, and runs every case.

Cases, 2 steps each, B=4 x 32, float32 reduced configs, max_grad_norm 5.0
(below every step's grad norm, so the clip is active):

- ``ssm``: reduced mamba2-1.3b, AdamW with ZeRO-1 moments (the sharded
  Mamba2 block);
- ``hybrid``: reduced zamba2-7b at 7 layers, AdamW (2 super-blocks over 2
  shared attention blocks, and a tail layer);
- ``moe_alltoall``: reduced kimi-k2-1t-a32b (4 experts over 2 data ranks:
  "alltoall"), the int8 dispatch, Adafactor, grad_accum 2;
- ``moe_gathered``: reduced grok-1-314b with 3 experts ("gathered": d_ff
  gathered over data and model), the attention's softcap, Adafactor.

Also held: `comm.quantize_int8`'s codes and scales equal to the JAX
package's formula on the same input, and `comm.quantized_all_to_all`
over 4 ranks and its gradient equal to the JAX package's
`quantized_all_to_all` and its custom VJP, bit for bit; the hybrid's and
the MoE's states saved sharded on (2, 2) and restored onto (1, 4) (where
kimi's experts are "gathered") equal to the gathered state, bit for bit;
the launcher's sharded build and loop (`launch.train.build_sharded`,
`train_loop` with a sharded checkpoint) on both.

Tolerances: those of `tests/test_torch_lm_mesh.py` (float32): the
metrics within 1e-5 of the JAX value, the optimizer states within 1e-4 of
each leaf's largest magnitude, the parameters within 1% of one step's
update (0.01 lr).
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import pytest
import torch

from repro_torch import convert, pytree
from repro_torch.configs import get_config, reduced_config
from repro_torch.data import SyntheticLMData
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import transformer
from repro_torch.optim import get_optimizer
from repro_torch.runtime import checkpoint, train
from repro_torch.sharding import params as t_sp
from repro_torch.sharding.rules import MeshRules

ROOT = pathlib.Path(__file__).resolve().parents[1]
CLIP = 1.0
STEPS, B, S = 2, 4, 32
CASES = {   # name: (arch, overrides, steps)
    "ssm": ("mamba2-1.3b", {}, STEPS),
    "hybrid": ("zamba2-7b", {"n_layers": 7}, STEPS),
    "moe_alltoall": ("kimi-k2-1t-a32b", {"moe_a2a_int8": True,
                                         "grad_accum": 2,
                                         "grad_accum_dtype": "float32"},
                     STEPS),
    "moe_gathered": ("grok-1-314b", {"n_experts": 3}, STEPS),
    # the config's own bf16 accumulation: each microbatch's gradients
    # reduced over the batch axes before their rounding, as JAX's scan
    # does; held on the first step's metrics
    "moe_bf16_accum": ("kimi-k2-1t-a32b", {"moe_a2a_int8": True,
                                           "grad_accum": 2}, 1),
}
SSD = ("ssm", "hybrid")      # cases whose gradients pass the SSD's bf16
SSD_REL = 2.0 ** -8          # their gradients' limit (tests/test_torch_train)
RESTORED = ("hybrid", "moe_alltoall")    # saved on (2, 2), restored on (1, 4)
# the JAX side's two subprocesses, run at once: (cases, and "qa2a")
JAX_PARTS = (("ssm", "hybrid"),
             ("moe_alltoall", "moe_gathered", "moe_bf16_accum", "qa2a"))
QA2A_SHAPE = (16, 3, 8)                  # 4 ranks x 4 slots of (3, 8)

# argv: the inputs (.npz), the initial states (.npz, written first), the
# results (.npz), the comma-separated part (cases, and "qa2a") it runs
JAX_SIDE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config, reduced_config
from repro.models import transformer
from repro.models.moe import quantized_all_to_all
from repro.optim import get_optimizer
from repro.runtime import train
from repro.sharding import params as sp
from repro.sharding.rules import MeshRules

inp = np.load(sys.argv[1])
spec = json.loads(str(inp["spec"]))
part = sys.argv[4].split(",")


def flat(prefix, tree, out):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/" + "/".join(str(getattr(k, "key", k))
                                    for k in path)] = np.asarray(leaf)


init, out, metrics, todo, drawn = {}, {}, {}, {}, {}
for case in (c for c in spec["cases"] if c in part):
    arch, over, _ = spec["cases"][case]
    cfg = reduced_config(get_config(arch), **over)
    opt = get_optimizer(cfg)
    shapes = json.dumps([arch, {k: v for k, v in over.items()
                                if not k.startswith("grad_accum")}])
    if shapes not in drawn:
        drawn[shapes] = transformer.init_params(jax.random.PRNGKey(0), cfg)
    params = drawn[shapes]
    state = train.init_train_state(params, opt)
    flat(case + "/params", state.params, init)
    flat(case + "/opt", state.opt_state, init)
    todo[case] = (cfg, opt, state)
np.savez(sys.argv[2] + ".part.npz", **init)
os.replace(sys.argv[2] + ".part.npz", sys.argv[2])

mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
rules = MeshRules(tp=2, mesh=mesh)


def run(case, rules):
    cfg, opt, state = todo[case]
    if rules is not None:
        pspecs = sp.param_specs(cfg, rules, mesh)
        state = train.init_train_state(jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
            state.params, pspecs), opt)
    step = jax.jit(train.make_train_step(cfg, rules=rules, optimizer=opt,
                                         max_grad_norm=spec["clip"]))
    ms = []
    with mesh:
        for i in range(spec["cases"][case][2]):
            tokens = jax.device_put(jnp.asarray(inp[f"{case}/tokens/{i}"]),
                                    NamedSharding(mesh, P("data", None)))
            state, m = step(state, {"tokens": tokens})
            ms.append({k: float(v) for k, v in m.items()})
            if i == 0 and case in spec["ssd"]:
                flat(case + "/first/params", state.params, out)
                flat(case + "/first/opt", state.opt_state, out)
    return ms, state


for case in todo:
    metrics[case], state = run(case, rules)
    flat(case + "/params", state.params, out)
    flat(case + "/opt", state.opt_state, out)
if "qa2a" in part:
    mesh_e = Mesh(np.array(jax.devices()), ("e",))
    x, ct = jnp.asarray(inp["qa2a/x"]), jnp.asarray(inp["qa2a/ct"])
    y, vjp = jax.vjp(shard_map(lambda xl: quantized_all_to_all(xl, "e"),
                               mesh=mesh_e, in_specs=P("e"),
                               out_specs=P("e"), check_rep=False), x)
    out["qa2a/y"], out["qa2a/dx"] = np.asarray(y), np.asarray(vjp(ct)[0])
    # the codes and scales of the package's quantized_all_to_all, its lines
    amax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1, keepdims=True)
    scale = jnp.maximum(amax, 1e-9) / 127.0
    out["qa2a/scale"] = np.asarray(scale)
    out["qa2a/codes"] = np.asarray(jnp.clip(
        jnp.round(x.astype(jnp.float32) / scale), -127, 127).astype(
            jnp.int8))
out["metrics"] = np.asarray(json.dumps(metrics))
np.savez(sys.argv[3], **out)
"""


def _cfg(case):
    arch, over, _ = CASES[case]
    return reduced_config(get_config(arch), **over)


def _inputs() -> dict:
    """The arrays both sides take: each case's batches, the quantized
    exchange's input and cotangent (values over six decades), the
    spec."""
    out = {"spec": np.asarray(json.dumps({"cases": CASES, "clip": CLIP,
                                          "ssd": SSD}))}
    for case, (_, _, steps) in CASES.items():
        data = SyntheticLMData(_cfg(case).vocab_size, S, B, seed=2)
        for i in range(steps):
            out[f"{case}/tokens/{i}"] = data.batch(i)["tokens"]
    rng = np.random.default_rng(3)
    out["qa2a/x"] = (rng.normal(size=QA2A_SHAPE) * 10.0 ** rng.integers(
        -3, 3, size=(*QA2A_SHAPE[:2], 1))).astype(np.float32)
    out["qa2a/ct"] = rng.normal(size=QA2A_SHAPE).astype(np.float32)
    return out


def _unflat(arrays, prefix: str) -> dict:
    """The nested dict of the ``prefix/...`` keys of ``arrays``."""
    tree = {}
    for key in arrays:
        if key.startswith(prefix + "/"):
            *path, last = key[len(prefix) + 1:].split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[last] = np.asarray(arrays[key])
    return tree


def _numpy(tree):
    """Copies: a replicated leaf gathers to the live tensor itself, which
    the next step updates in place."""
    return pytree.tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(pytree.leaves(a),
                                                 pytree.leaves(b)))


def _ranks(init: dict, inputs: dict, ckpt_dir: str) -> dict:
    """Every check, on this rank of the 4."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import comm
    from repro_torch.launch import train as launch_train

    torch.set_num_threads(1)
    rank = dist.get_rank()
    mesh = t_mesh.make_host_mesh(4, ("data", "model"), device="cpu")
    rules = MeshRules(tp=2, mesh=mesh)
    out = {"rank": rank}
    states = {}
    for case in CASES:
        cfg = _cfg(case)
        state = convert.train_state_from_arrays(
            init[case]["params"], init[case]["opt"], 0, cfg, device="cpu",
            rules=rules)
        step = train.make_train_step(cfg, rules=rules,
                                     optimizer=get_optimizer(cfg),
                                     max_grad_norm=CLIP)
        specs = t_sp.train_state_specs(cfg, rules, mesh, cfg.optimizer)
        metrics = []
        for i in range(CASES[case][2]):
            batch = {"tokens": torch.as_tensor(inputs[f"{case}/tokens/{i}"])}
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0 and case in SSD:
                first = t_sp.gather_tree(state, specs, mesh)
                out[case + "/first"] = (_numpy(first.params),
                                        _numpy(first.opt_state))
        gathered = t_sp.gather_tree(state, specs, mesh)
        out[case] = (metrics, _numpy(gathered.params),
                     _numpy(gathered.opt_state), int(gathered.step))
        states[case] = (state, specs, gathered)

    # the new leaves through a sharded checkpoint, (2, 2) -> (1, 4)
    mesh14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    rules14 = MeshRules(tp=4, mesh=mesh14)
    for case in RESTORED:
        cfg = _cfg(case)
        state, specs, gathered = states[case]
        where = os.path.join(ckpt_dir, case)
        checkpoint.save_tree(where, STEPS, state, specs=specs, mesh=mesh)
        specs14 = t_sp.train_state_specs(cfg, rules14, mesh14, cfg.optimizer)
        like = train.init_sharded_train_state(
            t_sp.init_sharded_params(5, cfg, rules14, mesh14, device="cpu"),
            get_optimizer(cfg), cfg, rules14)
        like, _ = checkpoint.restore_tree(where, STEPS, like, specs=specs14,
                                          mesh=mesh14)
        out[f"restored_1x4/{case}"] = _same(
            t_sp.gather_tree(like, specs14, mesh14), gathered)

    # the launcher's sharded build and loop, a sharded checkpoint a step
    for case in RESTORED:
        cfg = _cfg(case)
        st, step_fn = launch_train.build_sharded(cfg, rules, steps=2,
                                                 device="cpu")
        specs = t_sp.train_state_specs(cfg, rules, mesh, cfg.optimizer)
        data = SyntheticLMData(cfg.vocab_size, S, B, seed=0)
        st, m = launch_train.train_loop(
            st, step_fn, data, cfg, start=0, steps=2, batch=B, device="cpu",
            ckpt_dir=os.path.join(ckpt_dir, "cli_" + case), ckpt_every=1,
            log=lambda line: None, specs=specs, mesh=mesh)
        out[f"launcher/{case}"] = (float(m["loss"]), int(st.step))

    # a group over two axes (RULES_3D's experts span pod and data): the
    # product, the first axis the major one, as JAX orders the blocks
    from repro_torch.sharding.spmd import axes_group

    both = axes_group(mesh, ("data", "model"))
    mine = torch.arange(4) + 10 * rank
    out["two_axes"] = (dist.get_process_group_ranks(both),
                       comm.all_to_all_cat(mine, both).tolist())
    try:
        axes_group(mesh, ("model", "data"))
        out["two_axes_refused"] = False
    except ValueError:
        out["two_axes_refused"] = True

    # the int8 exchange over the 4 ranks, and its gradient
    group = init_device_mesh("cpu", (4,), mesh_dim_names=("e",)).get_group(
        "e")
    n = QA2A_SHAPE[0] // 4
    x = torch.as_tensor(inputs["qa2a/x"][rank * n:(rank + 1) * n].copy())
    codes, scale = comm.quantize_int8(x)
    x.requires_grad_(True)
    y = comm.quantized_all_to_all(x, group)
    y.backward(torch.as_tensor(inputs["qa2a/ct"][rank * n:(rank + 1) * n]
                               .copy()))
    out["qa2a"] = {"codes": codes.numpy(), "scale": scale.numpy(),
                   "y": y.detach().numpy(), "dx": x.grad.numpy()}
    return out


@pytest.fixture(scope="module")
def runs():
    """(JAX's results, the ranks' results), once for the module: the JAX
    side in two subprocesses at once (`JAX_PARTS`), the ranks spawned as
    soon as both have written their initial states."""
    pytest.importorskip("jax")
    with tempfile.TemporaryDirectory(prefix="lm_mesh_kinds_") as d:
        inputs = _inputs()
        np.savez(os.path.join(d, "in.npz"), **inputs)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
                   + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
        procs = []
        for i, part in enumerate(JAX_PARTS):
            paths = [os.path.join(d, f) for f in
                     ("in.npz", f"init{i}.npz", f"out{i}.npz")]
            procs.append((paths, subprocess.Popen(
                [sys.executable, "-c", JAX_SIDE, *paths, ",".join(part)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        init, want, metrics = {}, {}, {}
        for paths, proc in procs:
            while not os.path.exists(paths[1]) and proc.poll() is None:
                time.sleep(0.2)
            if not os.path.exists(paths[1]):
                pytest.fail("the JAX side wrote no initial states:\n"
                            + proc.communicate()[0][-4000:])
            with np.load(paths[1]) as f:
                init.update({case: {"params": _unflat(f, case + "/params"),
                                    "opt": _unflat(f, case + "/opt")}
                             for case in CASES if case + "/params/embed"
                             in f.files})
        outs = t_mesh.spawn(_ranks, 4, "cpu", (init, inputs, d))
        for paths, proc in procs:
            log = proc.communicate(timeout=600)[0]
            assert proc.returncode == 0, log[-4000:]
            with np.load(paths[2]) as f:
                want.update({k: f[k] for k in f.files if k != "metrics"})
                metrics.update(json.loads(str(f["metrics"])))
    yield types.SimpleNamespace(want=want, metrics=metrics, outs=outs,
                                init=init)


def _hold(got, want, base, only=None):
    """Every leaf of ``got`` within ``base(w)`` of the JAX leaf ``w`` (where
    ``only(key, w)`` holds, given)."""
    got = {pytree.path_str(p): t for p, t in pytree.leaves_with_paths(got)}
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w, np.float32)
        diff = np.abs(np.asarray(got[key], np.float32) - w)
        if only is not None:
            diff = np.where(only(key, w), diff, 0.0)
        err, tol = float(diff.max()), base(w)
        assert err <= tol, (key, err, tol)


def _scale(w) -> float:
    return max(float(np.abs(w).max()), 1e-30)


def _strip(want: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in want.items()
            if k.startswith(prefix + "/")}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_steps_match_jax(runs, case):
    """Every step's metrics within 1e-5 (the SSD cases: see
    `test_ssd_cases_match_jax`), then the state within 1e-4 of each
    leaf's scale and the parameters within 1% of a step's update (the
    config's own bf16 accumulation: its first step's metrics alone)."""
    cfg = _cfg(case)
    lr = 1e-2 if cfg.optimizer == "adafactor" else 1e-3   # the defaults
    steps = CASES[case][2]
    want_m = runs.metrics[case]
    for out in runs.outs:
        got_m, got_p, got_s, got_step = out[case]
        assert got_step == steps == len(want_m)
        for i, (g, w) in enumerate(zip(got_m, want_m)):
            assert set(g) == set(w)
            assert g["grad_norm"] > CLIP              # the clip is active
            if case in SSD:
                continue
            for key in g:
                assert abs(g[key] - w[key]) <= 1e-5 * max(abs(w[key]), 1.0), \
                    (case, i, key, g[key], w[key])
        if steps < STEPS or case in SSD:
            continue
        _hold(got_p, _strip(runs.want, case + "/params"), lambda w: 0.01 * lr)
        _hold(got_s, _strip(runs.want, case + "/opt"),
              lambda w: 1e-4 * _scale(w))


@pytest.mark.parametrize("case", SSD)
def test_ssd_cases_match_jax(runs, case):
    """The SSD rounds its weight block and inputs to bf16, and autograd
    rounds their cotangents alike, so two summation orders that differ in
    a float32 last bit can round one element to the next bf16 value: the
    gradients agree to 2^-8 of their scale (`tests/test_torch_train.py`'s
    limit for one device), and AdamW's first update, about lr times the
    sign of the gradient, flips an element whose gradient lies that close
    to zero. (The JAX package's own sharded and unsharded steps differ so:
    by up to 1.1 lr (ssm) and 2.0 lr (hybrid) in parameters after 2
    steps, and by 1.5e-4 in the hybrid's second grad norm, measured on the
    CPU with JAX 0.9.0.) So these cases hold: step 1's loss and ce_loss
    within 1e-5 and its grad norm within 1e-4; AdamW's first moment after
    step 1 (0.1 times the clipped gradient) within 2^-8 of its scale and
    the second within 2^-7; the parameters after step 1 within 1% of an
    update wherever the gradient is over 2^-8 of its scale (its sign
    resolved); step 2's metrics within 1e-3."""
    lr = 1e-3
    first_p = _strip(runs.want, case + "/first/params")
    m1 = _strip(runs.want, case + "/first/opt/m")
    for out in runs.outs:
        got_m = out[case][0]
        for i, (g, w) in enumerate(zip(got_m, runs.metrics[case])):
            for key in g:
                rel = (1e-3 if i else 1e-4 if key == "grad_norm" else 1e-5)
                assert abs(g[key] - w[key]) <= rel * max(abs(w[key]), 1.0), \
                    (case, i, key, g[key], w[key])
        got_p, got_s = out[case + "/first"]
        _hold(got_s["m"], m1, lambda w: SSD_REL * _scale(w))
        _hold(got_s["v"], _strip(runs.want, case + "/first/opt/v"),
              lambda w: 2 * SSD_REL * _scale(w))
        _hold(got_p, first_p, lambda w: 0.01 * lr,
              only=lambda key, w: np.abs(m1[key]) > SSD_REL * _scale(m1[key]))


def test_every_rank_gathers_the_same_state(runs):
    first = runs.outs[0]
    for out in runs.outs[1:]:
        for case in CASES:
            assert out[case][0] == first[case][0]
            for a, b in zip(pytree.leaves(out[case][1:3]),
                            pytree.leaves(first[case][1:3])):
                np.testing.assert_array_equal(a, b)


def test_quantized_all_to_all_matches_jax(runs):
    """The codes and scales of each rank's block, the exchanged values and
    the gradient (the full-width cotangent exchanged back): equal."""
    n = QA2A_SHAPE[0] // 4
    for out in runs.outs:
        got, r = out["qa2a"], out["rank"]
        blk = slice(r * n, (r + 1) * n)
        np.testing.assert_array_equal(got["codes"],
                                      runs.want["qa2a/codes"][blk])
        np.testing.assert_array_equal(got["scale"],
                                      runs.want["qa2a/scale"][blk])
        np.testing.assert_array_equal(got["y"], runs.want["qa2a/y"][blk])
        np.testing.assert_array_equal(got["dx"], runs.want["qa2a/dx"][blk])
    assert any(np.abs(out["qa2a"]["codes"]).max() == 127 for out in runs.outs)


@pytest.mark.parametrize("case", RESTORED)
def test_elastic_restore_of_the_new_leaves(runs, case):
    """Saved on (2, 2), restored onto (1, 4) (kimi's experts there
    "gathered", the hybrid's heads and channels over 4): the gathered
    state, bit for bit."""
    assert all(out[f"restored_1x4/{case}"] for out in runs.outs)


@pytest.mark.parametrize("case", RESTORED)
def test_launcher_trains_the_new_kinds(runs, case):
    losses = {out[f"launcher/{case}"] for out in runs.outs}
    assert len(losses) == 1
    loss, step = losses.pop()
    assert np.isfinite(loss) and step == 2


def test_moe_sharded_step_differs_from_one_device(runs):
    """The JAX package's design, held: on the mesh each rank routes its own
    tokens at its own capacity and the aux is the mean of the ranks' local
    losses, so the sharded MoE step is not the single-device step from
    the same state (which routes the batch at once); the ``ssm`` case,
    which routes nothing, is."""
    for case, differs in (("moe_gathered", True), ("ssm", False)):
        cfg = _cfg(case)
        state = convert.train_state_from_arrays(
            runs.init[case]["params"], runs.init[case]["opt"], 0, cfg,
            device="cpu")
        batch = {"tokens": torch.as_tensor(_inputs()[f"{case}/tokens/0"])}
        _, one = train.make_train_step(cfg, optimizer=get_optimizer(cfg),
                                       max_grad_norm=CLIP)(state, batch)
        mesh = runs.outs[0][case][0][0]
        for key in ("loss", "grad_norm"):
            gap = abs(float(one[key]) - mesh[key]) / abs(mesh[key])
            assert (gap > 1e-3) == differs, (case, key, gap)
        if differs:
            assert abs(float(one["aux_loss"]) - mesh["aux_loss"]) > 1e-3


def test_a_group_over_two_axes_orders_the_first_major(runs):
    """`spmd.axes_group` over (data, model) on the (2, 2) mesh: rank r of
    the group is the rank at (r // 2, r % 2), and an all-to-all over it
    hands block j to group rank j; axes out of the mesh's order are
    refused."""
    for out in runs.outs:
        ranks, got = out["two_axes"]
        assert ranks == [0, 1, 2, 3]
        assert got == [out["rank"] + 10 * j for j in range(4)]
        assert out["two_axes_refused"]
