"""The port's sharded LM train step on a (data=2, model=2) mesh of 4 gloo
ranks on the CPU, held to the JAX package's jitted UNSHARDED step from the
same state (GSPMD's sharding changes no result, so that is the
reference).

One group of 4 ranks is spawned once (`launch.mesh.spawn`) and runs every
check; the JAX package's steps run once, in this process. Two cases, two
steps each, from `convert.train_state_from_arrays(..., rules=)` shards of
the JAX package's initial state, max_grad_norm 5.0, below every step's
grad norm (7.7 to 11.3), so the clip is active in every step. (At 0.05,
`tests/test_torch_train_step.py`'s clip, the clipped gradients sink
toward AdamW's eps of 1e-8, where an update lr m / (sqrt v + eps) turns on
the rounding of a near-zero gradient: measured 1.4% of a step in the
embedding, whose gradients equal the single-device step's within 7.4e-7
of their scale.)

- ``kv_repeat``: reduced minitron-8b with 4 heads over 1 kv head, so
  `head_sharding` at tp 2 gives ("sharded", 2): heads over ``model``, the
  kv weights ZeRO-3-sharded over ``data``, repeated and cut on use; AdamW
  with ZeRO-1 moments; grad_accum 2;
- ``replicated``: reduced paligemma-3b with 3 heads (replicated heads,
  every attention weight ZeRO-3-sharded over ``data``, the queries
  sequence-sharded), its vlm prefix, Adafactor with factored moments.

Also held: each rank's ZeRO-1 moment shapes against the spec tree;
`shard_tree` then `gather_tree` the identity; a sharded checkpoint of the
first case saved on (2, 2) and restored onto (1, 4) and onto one device
equal to the gathered state, bit for bit; `optim.compress.compressed_psum`
over a 2-rank ``pod`` axis equal to the JAX package's under
`jax.vmap(..., axis_name="pod")`; each case's collectives at head dim 64
(a head dim of the attention kernel, whose meta branch holds to the
card's), counted by `core.comm` on every rank in one real step, equal
per kind (count, result bytes, bytes sent) to the dry run's
(`launch.dryrun.cell_inputs` on a fake (2, 2) group, run in a subprocess
while the ranks work: a fake group wants a process with no group).

Tolerances: those of `tests/test_torch_train_step.py` (float32): the
metrics within 1e-5 of the JAX value, the optimizer states within 1e-4 of
each leaf's largest magnitude, the parameters within 1% of one step's
update (0.01 lr). The compressed mean: equal (the same int8 codes and
float32 products on both sides).
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import types

import numpy as np
import pytest
import torch

from repro_torch import convert, pytree
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import comm
from repro_torch.data import SyntheticLMData
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch.step_analysis import JAX_KIND
from repro_torch.models import transformer
from repro_torch.optim import get_optimizer
from repro_torch.optim import compress
from repro_torch.runtime import checkpoint, train
from repro_torch.sharding import params as t_sp
from repro_torch.sharding.rules import MeshRules

CLIP = 5.0
STEPS, B, S = 2, 4, 32
CASES = {
    "kv_repeat": ("minitron-8b", dict(n_kv_heads=1, grad_accum=2)),
    "replicated": ("paligemma-3b", dict(n_heads=3, n_kv_heads=1,
                                        optimizer="adafactor")),
}
PSUM_SHAPES = ((5, 7), (33,))
COMM_HD = 64     # the collectives' cells: a head dim the kernel takes
ROOT = pathlib.Path(__file__).resolve().parents[1]

# argv: {case: [arch, overrides]}, B, S; prints {case: [each rank's
# collectives]}
DRY_SIDE = r"""
import json, sys
import torch
from repro_torch.configs import ShapeConfig, get_config, reduced_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh

torch.set_num_threads(1)
cells, b, s = json.loads(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
out = {}
for case, (arch, over) in cells.items():
    cfg = reduced_config(get_config(arch), **over)
    out[case] = []
    for rank in range(4):
        with dryrun.fake_group(4, rank):
            mesh = make_host_mesh(4, ("data", "model"), device="cpu")
            out[case].append(dryrun.timed_analysis(*dryrun.cell_inputs(
                cfg, ShapeConfig("cell", s, b, "train"), mesh))
                ["collectives"])
print(json.dumps(out))
"""


def _cfg(configs, case):
    arch, over = CASES[case]
    return configs.reduced_config(configs.get_config(arch), **over)


def _comm_cells() -> dict:
    return {case: (arch, dict(over, head_dim=COMM_HD))
            for case, (arch, over) in CASES.items()}


def _batch(cfg, step) -> dict:
    data = SyntheticLMData(cfg.vocab_size, S - cfg.prefix_len, B, seed=2)
    out = {"tokens": data.batch(step)["tokens"]}
    if cfg.prefix_len:
        rng = np.random.default_rng(step)
        out["prefix_embed"] = rng.normal(
            size=(B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return out


def _psum_inputs(pod: int) -> dict:
    rng = np.random.default_rng(10 + pod)
    return {str(i): (rng.normal(size=shp) * 10 ** i).astype(np.float32)
            for i, shp in enumerate(PSUM_SHAPES)}


def _numpy(tree):
    return pytree.tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _ranks(inputs: dict, ckpt_dir: str) -> dict:
    """Every check, on this rank of the 4."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import configs

    torch.set_num_threads(1)
    mesh = t_mesh.make_host_mesh(4, ("data", "model"), device="cpu")
    rules = MeshRules(tp=2, mesh=mesh)
    out = {"rank": dist.get_rank()}
    for case, (params_np, opt_np) in inputs["states"].items():
        cfg = _cfg(configs, case)
        state = convert.train_state_from_arrays(params_np, opt_np, 0, cfg,
                                                device="cpu", rules=rules)
        specs = t_sp.train_state_specs(cfg, rules, mesh, cfg.optimizer)
        if case == "kv_repeat":
            full = t_sp.gather_tree(state, specs, mesh)
            again = t_sp.gather_tree(t_sp.shard_tree(full, specs, mesh),
                                     specs, mesh)
            out["identity"] = all(torch.equal(a, b) for a, b in zip(
                pytree.leaves(full), pytree.leaves(again)))
            out["moment_shapes"] = {
                pytree.path_str(p): tuple(t.shape)
                for p, t in pytree.leaves_with_paths(state.opt_state["m"])}
        step = train.make_train_step(cfg, rules=rules,
                                     optimizer=get_optimizer(cfg),
                                     max_grad_norm=CLIP)
        metrics = []
        for i in range(STEPS):
            batch = {k: torch.as_tensor(v)
                     for k, v in _batch(cfg, i).items()}
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        gathered = t_sp.gather_tree(state, specs, mesh)
        out[case] = (metrics, _numpy(gathered.params),
                     _numpy(gathered.opt_state), int(gathered.step))
        if case == "kv_repeat":
            checkpoint.save_tree(ckpt_dir, STEPS, state, specs=specs,
                                 mesh=mesh)
            mesh14 = init_device_mesh("cpu", (1, 4),
                                      mesh_dim_names=("data", "model"))
            rules14 = MeshRules(tp=4, mesh=mesh14)
            specs14 = t_sp.train_state_specs(cfg, rules14, mesh14,
                                             cfg.optimizer)
            like = train.init_sharded_train_state(
                t_sp.init_sharded_params(5, cfg, rules14, mesh14,
                                         device="cpu"),
                get_optimizer(cfg), cfg, rules14)
            like, _ = checkpoint.restore_tree(ckpt_dir, STEPS, like,
                                              specs=specs14, mesh=mesh14)
            back = t_sp.gather_tree(like, specs14, mesh14)
            out["elastic_1x4"] = all(torch.equal(a, b) for a, b in zip(
                pytree.leaves(back), pytree.leaves(gathered)))
    out["comm"] = {}
    for case, (arch, over) in _comm_cells().items():
        cfg = configs.reduced_config(configs.get_config(arch), **over)
        opt = get_optimizer(cfg)
        state = train.init_sharded_train_state(
            t_sp.init_sharded_params(0, cfg, rules, mesh, device="cpu"), opt,
            cfg, rules)
        comm.reset_collectives()
        train.make_train_step(cfg, rules=rules, optimizer=opt)(
            state, {k: torch.as_tensor(v) for k, v in _batch(cfg, 0).items()})
        out["comm"][case] = (dict(comm.COLLECTIVES),
                             dict(comm.COLLECTIVE_RESULT_BYTES),
                             dict(comm.COLLECTIVE_BYTES))
    pods = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "model"))
    mean = compress.make_crosspod_mean(pods, "pod")(pytree.tree_map(
        torch.as_tensor, _psum_inputs(pods.get_local_rank("pod"))))
    out["psum"] = _numpy(mean)
    return out


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.models import transformer as j_tf
    from repro.optim import compress as j_compress
    from repro.optim import get_optimizer as j_get_optimizer
    from repro.runtime import train as j_train
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, configs=configs,
                                 tf=j_tf, train=j_train, compress=j_compress,
                                 get_optimizer=j_get_optimizer)


@pytest.fixture(scope="module")
def runs(jx):
    """(JAX's initial states and steps, the ranks' results, the
    checkpoint directory, the dry run's collectives), once for the
    module."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    dry = subprocess.Popen(
        [sys.executable, "-c", DRY_SIDE, json.dumps(_comm_cells()), str(B),
         str(S)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    to_np = lambda t: jx.jax.tree.map(np.asarray, t)  # noqa: E731
    states, want = {}, {}
    for case in CASES:
        cfg = _cfg(jx.configs, case)
        opt = jx.get_optimizer(cfg)
        state = jx.train.init_train_state(
            jx.tf.init_params(jx.jax.random.PRNGKey(0), cfg), opt)
        states[case] = (to_np(state.params), to_np(state.opt_state))
        step = jx.jax.jit(jx.train.make_train_step(cfg, optimizer=opt,
                                                   max_grad_norm=CLIP))
        metrics = []
        for i in range(STEPS):
            state, m = step(state, {k: jx.jnp.asarray(v)
                                    for k, v in _batch(cfg, i).items()})
            metrics.append({k: float(v) for k, v in m.items()})
        want[case] = (metrics, to_np(state.params), to_np(state.opt_state),
                      int(state.step))
    with tempfile.TemporaryDirectory(prefix="lm_mesh_ckpt_") as d:
        outs = t_mesh.spawn(_ranks, 4, "cpu", ({"states": states}, d))
        like = train.init_train_state(
            convert.lm_params_from_arrays(states["kv_repeat"][0],
                                          _cfg(jx.configs, "kv_repeat"),
                                          device="cpu"),
            get_optimizer(reduced_config(get_config("minitron-8b"),
                                         **CASES["kv_repeat"][1])))
        restored, _ = checkpoint.restore_tree(d, STEPS, like)
        log, err = dry.communicate(timeout=600)
        assert dry.returncode == 0, err[-4000:]
        yield types.SimpleNamespace(want=want, outs=outs, restored=restored,
                                    dry=json.loads(log.splitlines()[-1]))


def _hold(got, want, rel=None, atol=None):
    got = {pytree.path_str(p): t for p, t in pytree.leaves_with_paths(got)}
    for path, w in pytree.leaves_with_paths(want):
        key = pytree.path_str(path)
        w = np.asarray(w, np.float32)
        tol = atol if atol is not None else \
            rel * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(np.asarray(got[key], np.float32) - w).max())
        assert err <= tol, (key, err, tol)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_steps_match_jax(runs, case):
    want_m, want_p, want_s, want_step = runs.want[case]
    cfg = reduced_config(get_config(CASES[case][0]), **CASES[case][1])
    lr = 1e-2 if cfg.optimizer == "adafactor" else 1e-3   # the defaults
    for out in runs.outs:
        got_m, got_p, got_s, got_step = out[case]
        assert got_step == want_step == STEPS
        for g, w in zip(got_m, want_m):
            assert set(g) == set(w)
            for key in g:
                assert abs(g[key] - w[key]) <= 1e-5 * max(abs(w[key]), 1.0), \
                    (case, key, g[key], w[key])
            assert g["grad_norm"] > CLIP              # the clip is active
        _hold(got_p, want_p, atol=0.01 * lr)
        _hold(got_s, want_s, rel=1e-4)


def test_every_rank_gathers_the_same_state(runs):
    first = runs.outs[0]
    for out in runs.outs[1:]:
        for case in CASES:
            for a, b in zip(pytree.leaves(out[case][1:3]),
                            pytree.leaves(first[case][1:3])):
                np.testing.assert_array_equal(a, b)


def test_zero1_moments_are_the_specs_blocks(runs):
    cfg = reduced_config(get_config("minitron-8b"), **CASES["kv_repeat"][1])
    sizes = {"data": 2, "model": 2}
    specs = t_sp.opt_state_specs(cfg, MeshRules(tp=2), sizes, "adamw")["m"]
    shapes = {pytree.path_str(p): tuple(t.shape) for p, t in
              pytree.leaves_with_paths(transformer.param_shapes(cfg))}
    for out in runs.outs:
        for key, got in out["moment_shapes"].items():
            spec = pytree.get(specs, tuple(key.split("/")))
            assert got == t_sp.local_shape(shapes[key], spec, sizes), key
    sharded = [k for k in shapes if "data" in t_sp.spec_axes(
        pytree.get(specs, tuple(k.split("/"))))]
    assert "embed" in sharded and "layers/ffn/wi" in sharded


def test_shard_then_gather_is_the_identity(runs):
    assert all(out["identity"] for out in runs.outs)


def test_elastic_restore(runs):
    """The (2, 2) checkpoint on (1, 4) and on one device: the gathered
    state, bit for bit."""
    assert all(out["elastic_1x4"] for out in runs.outs)
    _, want_p, want_s, _ = runs.outs[0]["kv_repeat"]
    got = runs.restored
    assert int(got.step) == STEPS
    for (path, a), b in zip(pytree.leaves_with_paths(got.params),
                            pytree.leaves(want_p)):
        np.testing.assert_array_equal(a.numpy(), b,
                                      err_msg=pytree.path_str(path))
    for a, b in zip(pytree.leaves(got.opt_state), pytree.leaves(want_s)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_compressed_psum_matches_jax(runs, jx):
    stacked = {k: np.stack([_psum_inputs(0)[k], _psum_inputs(1)[k]])
               for k in _psum_inputs(0)}
    want = jx.jax.vmap(lambda g: jx.compress.compressed_psum(g, "pod"),
                       axis_name="pod")(
        {k: jx.jnp.asarray(v) for k, v in stacked.items()})
    for out in runs.outs:
        for k in stacked:
            np.testing.assert_array_equal(out["psum"][k],
                                          np.asarray(want[k])[0])


@pytest.mark.parametrize("case", list(CASES))
def test_collectives_equal_the_dry_run(runs, case):
    """A real sharded step's collectives on each gloo rank equal, kind by
    kind, what the dry run counts for that rank on a fake (2, 2) group:
    the count, the result bytes and the bytes sent."""
    for out in runs.outs:
        counts, result, sent = out["comm"][case]
        want = runs.dry[case][out["rank"]]
        assert sum(counts.values()) > 0
        for kind, name in JAX_KIND.items():
            assert (counts[kind], result[kind], sent[kind]) == (
                want[name]["count"], want[name]["bytes"],
                want[name]["sent_bytes"]), (case, kind)
