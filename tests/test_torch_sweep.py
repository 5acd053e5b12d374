"""The port's full-suite sweep (`repro_torch.search.sweep`) against the JAX
package's (`repro.search.sweep`), on the CPU, and its batched kernels on the
card.

Campaign: the seeds and vertebral trees, a two-tree seeds forest and two
printed MLPs (seeds and vertebral, hidden 4, on the JAX package's masters):
the JAX package's own sweep campaign plus an MLP bucket.

Tolerances: exact equality, except
- padded against unpadded objectives (2e-6, the JAX test's own tolerance):
  the padded formula divides the correct count by the real row count and
  scales integer quanta to mm^2 before dividing, where `objectives`
  multiplies by a reciprocal and divides quanta by quanta;
- the jitted JAX `population_objectives` (2^-23): under `jax.jit` XLA
  fuses the area's ``units * quantum + overhead`` into one rounding; the
  port equals the un-jitted `padded_objectives` exactly.

The JAX package is imported by a fixture, not at the top: the machine with
the card has no JAX and runs this file's card tests alone with ``python -m
pytest -m torch_cuda tests/test_torch_sweep.py``.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch import kernels
from repro_torch import search as t_search
from repro_torch.core import forest as t_forest
from repro_torch.core import nsga2 as t_nsga2
from repro_torch.core import quant as t_quant
from repro_torch.core import train as t_train
from repro_torch.core import tree as t_tree
from repro_torch.datasets import load_dataset, paper_refs
from repro_torch.families import printed_mlp as t_pm
from repro_torch.kernels import domination as t_dom
from repro_torch.kernels import fitness as t_fit
from repro_torch.search import sweep as t_sweep

REPO = pathlib.Path(__file__).resolve().parents[1]
JIT_TOL = 2.0 ** -23
PADDED_TOL = 2e-6
MLP_HIDDEN = 4


@pytest.fixture(scope="module")
def jx():
    """The JAX package's sweep, search, families and numpy bridge."""
    jnp = pytest.importorskip("jax.numpy")
    import jax
    from repro import search
    from repro.core import forest, train, tree
    from repro.datasets import load_dataset as j_load
    from repro.datasets import paper_refs as j_refs
    from repro.families import printed_mlp
    from repro.search import sweep
    return types.SimpleNamespace(jax=jax, jnp=jnp, search=search,
                                 sweep=sweep, forest=forest, train=train,
                                 tree=tree, load=j_load, refs=j_refs,
                                 pm=printed_mlp)


def _port_campaign(jx, device="cpu"):
    problems = {}
    for name in ("seeds", "vertebral"):
        ds = load_dataset(name)
        pt = t_tree.to_parallel(t_train.train_tree(ds.x_train, ds.y_train,
                                                   ds.n_classes))
        problems[name] = t_search.build_tree_problem(pt, ds.x_test, ds.y_test,
                                                     device=device)
    ds = load_dataset("seeds")
    fr = t_forest.train_forest(ds.x_train, ds.y_train, ds.n_classes,
                               n_trees=2)
    problems["seeds_forest2"] = t_search.build_forest_problem(
        fr, ds.x_test, ds.y_test, device=device)
    jax_mlps = {}
    for name in ("seeds", "vertebral"):
        jp = jx.pm.build_problem(name, n_hidden=MLP_HIDDEN)
        jax_mlps[f"{name}_mlp"] = jp
        problems[f"{name}_mlp"] = convert.mlp_problem_from_arrays(
            jp.w1_master, jp.w2_master, jp.shift, jp.n_classes, jp.x8, jp.y,
            device=device)
    return problems, jax_mlps


@pytest.fixture(scope="module")
def campaigns(jx):
    """(port campaign, JAX campaign): the same five problems."""
    port, jax_mlps = _port_campaign(jx)
    jax_c = {}
    for name in ("seeds", "vertebral"):
        ds = jx.load(name)
        pt = jx.tree.to_parallel(jx.train.train_tree(ds.x_train, ds.y_train,
                                                     ds.n_classes))
        jax_c[name] = jx.search.build_tree_problem(pt, ds.x_test, ds.y_test)
    ds = jx.load("seeds")
    fr = jx.forest.train_forest(ds.x_train, ds.y_train, ds.n_classes,
                                n_trees=2)
    jax_c["seeds_forest2"] = jx.search.build_forest_problem(
        fr, ds.x_test, ds.y_test)
    jax_c.update(jax_mlps)
    return port, jax_c


def _tree_dims(problems):
    """One merged tree bucket covering every tree problem."""
    trees = {k: v for k, v in problems.items() if not k.endswith("_mlp")}
    (bucket,) = t_sweep.plan_buckets(trees, max_buckets=1)
    return bucket.dims


def _pad_genes(rng, g_real, n_real, n_pad):
    """A padded tree chromosome holding ``g_real``'s genes: the comparator
    genes a prefix, the vote gene in the LAST padded column, random pads."""
    g = rng.uniform(0, 1, n_pad).astype(np.float32)
    g[:n_real - 1] = g_real[:-1]
    g[-1] = g_real[-1]
    return g


# ---------------------------------------------------------------------------
# padding semantics
# ---------------------------------------------------------------------------

def test_pad_genes_are_inert_bitexact(campaigns):
    """Two chromosomes that differ only in pad columns give bit-identical
    objectives (both routes) and predictions."""
    port, _ = campaigns
    dims = _tree_dims(port)
    rng = np.random.default_rng(0)
    for name, problem in port.items():
        if name.endswith("_mlp"):
            continue
        pp = t_sweep.pad_problem(problem, dims)
        g_real = rng.uniform(0, 1, problem.n_genes).astype(np.float32)
        a, b = (torch.as_tensor(_pad_genes(rng, g_real, problem.n_genes,
                                           pp.n_genes)) for _ in range(2))
        assert torch.equal(t_sweep.padded_objectives(pp, a),
                           t_sweep.padded_objectives(pp, b)), name
        assert torch.equal(t_sweep.padded_predict(pp, a),
                           t_sweep.padded_predict(pp, b)), name
        pop = torch.stack([a, b])
        objs = t_sweep.population_objectives(pp, pop)
        assert torch.equal(objs[0], objs[1]), name


def test_mlp_pad_genes_are_inert(campaigns):
    port, _ = campaigns
    problem = port["seeds_mlp"]
    h, c, f, b = t_pm.problem_dims(problem)
    dims = (16, 8, 16, 2 * b)
    pp = t_pm.pad_problem(problem, dims)
    fam = t_pm.FAMILY
    rng = np.random.default_rng(1)
    pop = rng.uniform(0, 1, (6, fam.padded_n_genes(dims))).astype(np.float32)
    other = rng.uniform(0, 1, pop.shape).astype(np.float32)
    real = fam.unpad_genes(problem, np.arange(pop.shape[1])[None], dims)[0]
    other[:, real] = pop[:, real]
    a = t_pm.padded_objectives(pp, torch.as_tensor(pop))
    b = t_pm.padded_objectives(pp, torch.as_tensor(other))
    assert torch.equal(a, b)
    # padded == unpadded: the real genes through the problem's own fitness
    want = t_pm.population_objectives(problem, torch.as_tensor(pop[:, real]))
    np.testing.assert_allclose(a.numpy(), want.numpy(), atol=PADDED_TOL)
    np.testing.assert_array_equal(a[:, 0].numpy(), want[:, 0].numpy())


def test_padded_matches_unpadded_semantics(campaigns):
    """Padded evaluation against the unpadded `SearchProblem`: real-row
    predictions equal, objectives within 2e-6."""
    port, _ = campaigns
    dims = _tree_dims(port)
    rng = np.random.default_rng(1)
    for name, problem in port.items():
        if name.endswith("_mlp"):
            continue
        pp = t_sweep.pad_problem(problem, dims)
        b_real = int(problem.x8.shape[0])
        for _ in range(4):
            g_real = rng.uniform(0, 1, problem.n_genes).astype(np.float32)
            g_pad = torch.as_tensor(_pad_genes(rng, g_real, problem.n_genes,
                                               pp.n_genes))
            bits, t_sub, cap = t_search.decode_chromosome(
                problem, torch.as_tensor(g_real))
            want = t_search.predict_votes(problem, bits, t_sub, cap)
            got = t_sweep.padded_predict(pp, g_pad)[:b_real]
            assert torch.equal(got, want), name
            want_obj = t_search.objectives(problem,
                                           torch.as_tensor(g_real)[None])[0]
            got_obj = t_sweep.padded_objectives(pp, g_pad)
            np.testing.assert_allclose(got_obj.numpy(), want_obj.numpy(),
                                       atol=PADDED_TOL, err_msg=name)


def test_pad_problem_rejects_too_small_dims(campaigns):
    port, _ = campaigns
    with pytest.raises(ValueError, match="smaller than"):
        t_sweep.pad_problem(port["vertebral"], (8, 8, 8, 8, 8))
    with pytest.raises(ValueError, match="smaller than"):
        t_pm.pad_problem(port["seeds_mlp"], (2, 2, 2, 2))


def test_padded_objectives_match_jax(jx, campaigns):
    """The port's padded objectives equal the JAX package's un-jitted
    `padded_objectives` exactly (both tree routes: the plain dataflow and
    the fitness kernel's plain version), and the jitted
    `population_objectives` within 2^-23."""
    port, jax_c = campaigns
    dims = _tree_dims(port)
    rng = np.random.default_rng(2)
    jit_pop = jx.jax.jit(jx.sweep.population_objectives)
    for name, problem in port.items():
        if name.endswith("_mlp"):
            continue
        pp = t_sweep.pad_problem(problem, dims)
        jpp = jx.sweep.pad_problem(jax_c[name], dims)
        pop = rng.uniform(0, 1, (12, pp.n_genes)).astype(np.float32)
        pop[0] = t_quant.exact_tree_genes(dims[0])
        want = np.stack([np.asarray(jx.sweep.padded_objectives(
            jpp, jx.jnp.asarray(g))) for g in pop])
        got = np.stack([t_sweep.padded_objectives(pp, torch.as_tensor(g))
                        .numpy() for g in pop])
        np.testing.assert_array_equal(got, want, err_msg=name)
        batch = t_sweep.population_objectives(pp, torch.as_tensor(pop))
        np.testing.assert_array_equal(batch.numpy(), want, err_msg=name)
        jitted = np.asarray(jit_pop(jpp, jx.jnp.asarray(pop)))
        np.testing.assert_allclose(got, jitted, rtol=JIT_TOL, atol=JIT_TOL,
                                   err_msg=name)


def test_mlp_padded_objectives_match_jax(jx, campaigns):
    port, jax_c = campaigns
    dims = (8, 4, 8, 128)
    pp = t_pm.pad_problem(port["seeds_mlp"], dims)
    jpp = jx.pm.pad_problem(jax_c["seeds_mlp"], dims)
    rng = np.random.default_rng(3)
    pop = rng.uniform(0, 1, (10, 2 * (dims[0] + dims[1]))).astype(np.float32)
    pop[0] = t_pm.exact_genes(dims[0] + dims[1])
    want = np.asarray(jx.pm.population_objectives(jpp, jx.jnp.asarray(pop)))
    got = t_pm.padded_objectives(pp, torch.as_tensor(pop)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0].tolist() == [0.0, 1.0]


# ---------------------------------------------------------------------------
# bucket planning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_buckets", [1, 2, 3, 6])
def test_plan_buckets_match_jax(jx, campaigns, max_buckets):
    port, jax_c = campaigns
    got = t_sweep.plan_buckets(port, max_buckets=max_buckets)
    want = jx.sweep.plan_buckets(jax_c, max_buckets=max_buckets)
    assert [(b.names, b.dims, b.family) for b in got] == [
        (b.names, b.dims, b.family) for b in want]
    for b in got:
        assert all(d & (d - 1) == 0 and d >= t_sweep.GRANULE for d in b.dims)
    assert got == t_sweep.plan_buckets(port, max_buckets=max_buckets)


def test_plan_buckets_rejects_zero_max(campaigns):
    with pytest.raises(ValueError, match="max_buckets"):
        t_sweep.plan_buckets(campaigns[0], max_buckets=0)


def test_paper_refs_match_jax(jx):
    for name in ("PAPER_TABLE1", "PAPER_TABLE2_NORM",
                 "PAPER_MEAN_AREA_REDUCTION_1PCT",
                 "PAPER_MEAN_POWER_REDUCTION_1PCT"):
        assert getattr(paper_refs, name) == getattr(jx.refs, name), name


# ---------------------------------------------------------------------------
# the contract: batched campaign == serial oracle, array for array
# ---------------------------------------------------------------------------

def _assert_same_results(a, b, names):
    for name in names:
        ra, rb = a.results[name], b.results[name]
        for f in ("genes", "objs", "rank", "crowd"):
            assert torch.equal(getattr(ra.state, f), getattr(rb.state, f)), \
                (name, f)
        np.testing.assert_array_equal(ra.pareto_objs, rb.pareto_objs, name)
        np.testing.assert_array_equal(ra.pareto_genes, rb.pareto_genes, name)


@pytest.mark.parametrize("max_buckets", [1, 3])
def test_vmapped_equals_serial(campaigns, max_buckets):
    """One merged tree bucket (two trees and a forest of three shapes) and
    one of both MLPs, or the planner's separate buckets: the batched
    campaign equals the serial loop array for array."""
    port, _ = campaigns
    kw = dict(pop_size=8, n_generations=3, seed=0, max_buckets=max_buckets)
    vm = t_sweep.run_sweep(port, vmapped=True, **kw)
    sr = t_sweep.run_sweep(port, vmapped=False, **kw)
    if max_buckets == 1:
        assert sorted(len(b.bucket.names) for b in vm.bucket_runs) == [2, 3]
    else:
        assert len(vm.bucket_runs) > 2
    _assert_same_results(vm, sr, port)


def test_dispatch_accounting(campaigns):
    port, _ = campaigns
    sweep = t_sweep.run_sweep(port, pop_size=8, n_generations=2,
                              max_buckets=1)
    assert len(sweep.bucket_runs) == 2           # the trees, the MLP
    assert sweep.n_dispatches == 4
    assert sweep.serial_baseline_dispatches() == 2 * len(port)
    for result in sweep.results.values():
        assert result.n_dispatches == 2
        assert result.n_evaluations == 8 * (1 + 2)
    serial = t_sweep.run_sweep(port, pop_size=8, n_generations=2,
                               max_buckets=1, vmapped=False)
    assert serial.n_dispatches == 2 * len(port)


def test_stacked_sort_and_plain_fitness_per_problem(campaigns):
    """The CPU legs of the batched kernels: the sort of K pools and the
    fitness of stacked operands equal each problem alone."""
    port, _ = campaigns
    rng = np.random.default_rng(4)
    objs = torch.as_tensor(rng.integers(0, 6, (3, 40, 2)).astype(np.float32))
    ranks = t_dom.non_dominated_rank(objs)
    rel, counts = t_dom.domination_bits(objs)
    for i in range(3):
        assert torch.equal(ranks[i], t_dom.non_dominated_rank(objs[i]))
        r1, c1 = t_dom.domination_bits(objs[i])
        assert torch.equal(rel[i], r1) and torch.equal(counts[i], c1)
    dims = _tree_dims(port)
    trees = [t_sweep.pad_problem(port[n], dims)
             for n in ("seeds", "vertebral", "seeds_forest2")]
    stacked = t_sweep.stack_padded(trees)
    pop = torch.as_tensor(rng.uniform(0, 1, (3, 10, trees[0].n_genes))
                          .astype(np.float32))
    both = t_sweep.population_objectives(stacked, pop)
    for i, pp in enumerate(trees):
        assert torch.equal(both[i], t_sweep.population_objectives(pp, pop[i]))


# ---------------------------------------------------------------------------
# artifacts, report, CLI
# ---------------------------------------------------------------------------

def _key_tree(x):
    if isinstance(x, dict):
        return {k: _key_tree(v) for k, v in x.items()}
    return type(x).__name__


def test_sweep_artifacts_unpadded_and_report(jx, campaigns, tmp_path):
    """Artifacts hold each problem's real genes; the report has the JAX
    package's keys for the same campaign, and equal values wherever the
    value does not depend on the search's random numbers."""
    port, jax_c = campaigns
    out = str(tmp_path / "port")
    sweep = t_sweep.run_sweep(port, pop_size=8, n_generations=2,
                              max_buckets=1, out_dir=out, verify_rtl=True)
    for name, problem in port.items():
        with open(os.path.join(out, name, "pareto.json")) as f:
            artifact = json.load(f)
        assert artifact["rtl_verified"]
        for point in artifact["pareto"]:
            assert len(point["genes"]) == problem.n_genes
            if not name.endswith("_mlp"):
                assert len(point["bits"]) == problem.n_comparators
                assert all(2 <= b <= 8 for b in point["bits"])
    meta = {"pop": 8, "gens": 2}
    json_path, md_path = t_sweep.write_sweep_report(sweep, port, out,
                                                    meta=meta)
    report = json.load(open(json_path))
    j_out = str(tmp_path / "jax")
    j_sweep = jx.sweep.run_sweep(jax_c, pop_size=8, n_generations=2,
                                 max_buckets=1, out_dir=j_out)
    j_json, _ = jx.sweep.write_sweep_report(j_sweep, jax_c, j_out, meta=meta)
    want = json.load(open(j_json))

    assert report.keys() == want.keys()
    assert report["summary"].keys() == want["summary"].keys()
    for k in ("meta", "n_dispatches", "serial_baseline_dispatches"):
        assert report[k] == want[k], k
    for got_b, want_b in zip(report["buckets"], want["buckets"]):
        got_b.pop("wall_s"), want_b.pop("wall_s")
        assert got_b == want_b
    assert report["datasets"].keys() == want["datasets"].keys()
    for name, row in report["datasets"].items():
        wrow = want["datasets"][name]
        assert row.keys() == wrow.keys(), name
        if row["at_budget"] and wrow["at_budget"]:
            assert row["at_budget"].keys() == wrow["at_budget"].keys()
        for k in ("exact_accuracy", "n_comparators", "n_trees", "n_hidden",
                  "family", "exact_area_mm2", "paper_accuracy",
                  "accuracy_delta", "paper_n_comparators", "paper_area_mm2"):
            assert row.get(k) == wrow.get(k), (name, k)
    assert "paper_accuracy" not in report["datasets"]["seeds_forest2"]
    assert report["datasets"]["seeds"]["netlist_vs_estimated_area"][
        "n_points"] >= 1
    md = open(md_path).read()
    assert "| dataset |" in md and "seeds_mlp" in md


def test_run_sweep_validates_config(campaigns):
    port, _ = campaigns
    with pytest.raises(ValueError, match="out_dir"):
        t_sweep.run_sweep(port, pop_size=8, n_generations=1, emit_rtl=True)
    with pytest.raises(ValueError, match="at least one"):
        t_sweep.run_sweep({})
    # a mesh larger than the process group (of one rank here)
    with pytest.raises(ValueError, match="needs 8 devices, the process "
                                         "group has 1 rank"):
        t_sweep.run_sweep(port, pop_size=8, n_generations=1, mesh="2x4")


def _cli(*argv, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.search", "sweep", *argv],
        capture_output=True, text=True, cwd=REPO, timeout=timeout,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})


def test_sweep_cli_smoke(tmp_path):
    """The sweep CLI on the CPU, batched then --serial: the same fronts bit
    for bit, verified against the netlist, with the report."""
    fronts = {}
    for mode in ("batched", "serial"):
        out = tmp_path / mode
        proc = _cli("--datasets", "seeds,vertebral", "--pop", "8", "--gens",
                    "2", "--out", str(out), "--report", "--verify-rtl",
                    "--device", "cpu", *(["--serial"] if mode == "serial"
                                         else []))
        assert proc.returncode == 0, proc.stderr
        assert "campaign:" in proc.stdout and "RTL verified" in proc.stdout
        assert (out / "sweep_report.json").exists()
        assert (out / "REPORT.md").exists()
        fronts[mode] = {n: [(p["acc_loss"], p["norm_area"], p["genes"])
                            for p in json.load(open(out / n /
                                                    "pareto.json"))["pareto"]]
                        for n in ("seeds", "vertebral")}
    assert fronts["batched"] == fronts["serial"]


def test_sweep_cli_rejects_unknown_dataset():
    proc = _cli("--datasets", "nope", "--pop", "8", "--gens", "1",
                "--device", "cpu", timeout=120)
    assert proc.returncode == 2 and "unknown datasets" in proc.stderr


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def _card_bucket(device):
    """The seeds and vertebral trees and the forest, padded to one bucket
    on the card, from the port's own training (no JAX)."""
    problems = {}
    for name in ("seeds", "vertebral"):
        ds = load_dataset(name)
        pt = t_tree.to_parallel(t_train.train_tree(ds.x_train, ds.y_train,
                                                   ds.n_classes))
        problems[name] = t_search.build_tree_problem(pt, ds.x_test, ds.y_test,
                                                     device=device)
    ds = load_dataset("seeds")
    fr = t_forest.train_forest(ds.x_train, ds.y_train, ds.n_classes,
                               n_trees=2)
    problems["seeds_forest2"] = t_search.build_forest_problem(
        fr, ds.x_test, ds.y_test, device=device)
    (bucket,) = t_sweep.plan_buckets(problems, max_buckets=1)
    return problems, [t_sweep.pad_problem(problems[n], bucket.dims)
                      for n in bucket.names]


@pytest.mark.torch_cuda
class TestSweepOnCuda:
    """The batched kernels and the batched chunk on the card."""

    def test_batched_kernels_equal_single_launches(self, cuda_device):
        _, padded = _card_bucket(cuda_device)
        stacked = t_sweep.stack_padded(padded)
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        pop = torch.rand((len(padded), 96, padded[0].n_genes), generator=gen,
                         device=cuda_device)
        shift, t_sub, cap = t_sweep.padded_fitness_args(stacked, pop)
        launches = kernels.launched(t_fit.fitness_correct_counts)
        both = t_fit.fitness_correct_counts(stacked.fit_ops, shift, t_sub,
                                            cap)
        assert kernels.launched(t_fit.fitness_correct_counts) == launches + 1
        plain = t_fit.fitness_correct_counts_plain(stacked.fit_ops, shift,
                                                   t_sub, cap)
        assert torch.equal(both, plain)
        for i, pp in enumerate(padded):
            one = t_fit.fitness_correct_counts(
                pp.fit_ops, shift[i].contiguous(), t_sub[i].contiguous(),
                cap[i].contiguous())
            assert torch.equal(both[i], one)
        objs = t_sweep.population_objectives(stacked, pop)
        ranks = t_dom.non_dominated_rank(objs)
        for i in range(len(padded)):
            assert torch.equal(ranks[i], t_dom.non_dominated_rank(
                objs[i].contiguous()))
            assert torch.equal(ranks[i].cpu(), t_dom.non_dominated_rank_plain(
                objs[i].cpu()))

    def test_captured_batched_chunk_equals_eager_loop(self, cuda_device):
        """`make_batched_chunk` (one CUDA graph for the bucket) equals the
        eager batched per-generation loop, generators included."""
        problems, padded = _card_bucket(cuda_device)
        stacked = t_sweep.stack_padded(padded)

        def fitness(pop):
            return t_sweep.population_objectives(stacked, pop)

        cfg = t_nsga2.NSGA2Config(pop_size=32)
        g = padded[0].n_genes
        seed_genes = t_quant.exact_tree_genes(padded[0].feature.shape[-1])

        def start():
            gens = list(t_sweep.problem_generators(sorted(problems), 5,
                                                   cuda_device).values())
            init = t_nsga2.make_batched_init(fitness, g, cfg, seed_genes)
            return gens, init(gens, cuda_device)

        gens, eager = start()
        step = t_nsga2.make_step(fitness, cfg)
        for _ in range(4):
            eager = step(eager, t_nsga2.draw_step(gens, 32, g, cuda_device))
        gens2, chunked = start()
        chunked = t_nsga2.make_batched_chunk(fitness, cfg, 4)(chunked, gens2)
        for f in ("genes", "objs", "rank", "crowd"):
            assert torch.equal(getattr(eager, f), getattr(chunked, f)), f
        for a, b in zip(gens, gens2):
            assert torch.equal(a.get_state(), b.get_state())
