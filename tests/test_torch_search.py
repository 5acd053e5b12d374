"""Parity of the port's search path (problem, objectives, NSGA-II, engine,
artifact, netlist, RTL) with the JAX package, on the CPU.

Tolerances: exact equality, except (a) the area objective, which the port
holds to the integer-quanta LUT (exact in any summation order) while the
JAX package sums the float mm^2 LUT in float32: the two agree to 1e-6
relative, and the port's value equals an independent integer-quanta sum
exactly; (b) offspring genes after SBX and mutation, which go through
`pow` and may differ by one float32 ulp between XLA and ATen (atol 1e-6).

The accuracy objective is held to the reference's un-jitted `objectives`
(two float32 roundings: the accuracy, then the loss). Under `jax.jit` XLA
fuses ``exact_accuracy - correct * (1/n)`` into one multiply-subtract with
a single rounding, so the jitted reference fitness scores the exact design
2^-26 (not 0) on `seeds` and can differ by one float32 ulp elsewhere; the
port keeps the two roundings.
"""
from __future__ import annotations

import ast
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import search as j_search
from repro.core import faults as j_faults
from repro.core import netlist as j_netlist
from repro.core import nsga2 as j_nsga2
from repro.core import rtl as j_rtl
from repro.core import train as j_train
from repro.core import tree as j_tree
from repro_torch import convert
from repro_torch import search as t_search
from repro_torch.core import area as t_area
from repro_torch.core import netlist as t_netlist
from repro_torch.core import nsga2 as t_nsga2
from repro_torch.core import quant as t_quant
from repro_torch.core import rtl as t_rtl
from repro_torch.core import train as t_train
from repro_torch.core import tree as t_tree
from repro_torch.datasets import load_dataset
from repro_torch.device import CudaUnavailableError

REPO = pathlib.Path(__file__).resolve().parents[1]


def _problems(name):
    ds = load_dataset(name)
    jp = j_search.build_tree_problem(
        j_tree.to_parallel(j_train.train_tree(ds.x_train, ds.y_train,
                                              ds.n_classes)),
        ds.x_test, ds.y_test)
    tp = t_search.build_problem(
        t_tree.to_parallel(t_train.train_tree(ds.x_train, ds.y_train,
                                              ds.n_classes)),
        ds.x_test, ds.y_test, device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def seeds():
    return _problems("seeds")


def _jax_fields(jp):
    fields = {f: np.asarray(getattr(jp, f)) for f in (
        "feature", "threshold", "path", "path_len", "n_neg", "leaf_class",
        "leaf_tree", "x8", "x_sel", "y", "area_lut", "lut_offsets")}
    scalars = {s: getattr(jp, s) for s in (
        "overhead_mm2", "exact_accuracy", "n_classes", "n_features",
        "n_trees", "tree_comparators", "tree_leaves")}
    return fields, scalars


def _random_pop(problem, n, seed):
    rng = np.random.default_rng(seed)
    genes = rng.random((n, problem.n_genes), dtype=np.float32)
    genes[0] = problem.exact_genes()
    exact = problem.exact_genes()
    # near-exact designs: a few genes moved, as the search's seeds are
    for i in range(1, n // 2):
        g = exact.copy()
        idx = rng.integers(0, problem.n_genes, 3)
        g[idx] = rng.random(3, dtype=np.float32)
        genes[i] = g
    return genes


def _jax_objectives(jp, genes):
    """The reference's `objectives` over a population, un-jitted."""
    return np.asarray(jax.vmap(functools.partial(j_search.problem.objectives,
                                                 jp))(jnp.asarray(genes)))


def _quanta_area(tp, genes):
    """Independent numpy integer-quanta area of genes (P, 3N+1)."""
    lut, off = t_area.build_area_unit_lut()
    bits, t_sub, _ = (x.numpy() for x in t_search.decode_chromosome(
        tp, torch.as_tensor(genes)))
    units = lut[off[bits] + t_sub].astype(np.int64).sum(-1) + tp.overhead_units
    return units


def test_build_problem_matches_jax(seeds):
    jp, tp = seeds
    fields, scalars = _jax_fields(jp)
    for name in ("feature", "threshold", "path", "path_len", "n_neg",
                 "leaf_class", "leaf_tree", "x8", "x_sel", "y", "lut_offsets"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), fields[name])
    np.testing.assert_allclose(tp.area_units.numpy() * t_area.AREA_QUANTUM_MM2,
                               fields["area_lut"], rtol=1e-6)
    assert tp.exact_accuracy == jp.exact_accuracy
    assert tp.exact_area_mm2 == pytest.approx(jp.exact_area_mm2, rel=1e-6)
    assert tp.overhead_mm2 == pytest.approx(jp.overhead_mm2, rel=1e-12)
    for name in ("n_classes", "n_features", "n_trees", "tree_comparators",
                 "tree_leaves", "n_genes"):
        assert getattr(tp, name) == getattr(jp, name)
    cp = convert.problem_from_arrays(fields, scalars, device="cpu")
    for f in dataclasses.fields(tp):
        a, b = getattr(tp, f.name), getattr(cp, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("name", ["seeds", "vertebral"])
def test_objectives_match_jax(name):
    jp, tp = _problems(name)
    genes = _random_pop(tp, 40, seed=len(name))
    expect = _jax_objectives(jp, genes)
    jitted = np.asarray(j_search.make_reference_fitness(jp)(jnp.asarray(genes)))
    # the jitted reference rounds once where `objectives` rounds twice
    np.testing.assert_allclose(jitted[:, 0], expect[:, 0], rtol=0,
                               atol=2.0 ** -23)
    ref = t_search.make_reference_fitness(tp)(torch.as_tensor(genes)).numpy()
    ker = t_search.make_kernel_fitness(tp)(torch.as_tensor(genes)).numpy()
    assert ref.dtype == np.float32
    np.testing.assert_array_equal(ref[:, 0], expect[:, 0])      # accuracy
    np.testing.assert_allclose(ref[:, 1], expect[:, 1], rtol=1e-6)
    units = _quanta_area(tp, genes)
    np.testing.assert_array_equal(
        ref[:, 1], units.astype(np.float32) / np.float32(tp.exact_units))
    assert ref[0, 0] == 0.0 and ref[0, 1] == 1.0                 # exact design
    np.testing.assert_array_equal(ker, ref)   # kernel backend == reference


@pytest.mark.parametrize("p", [64, 600])
def test_sort_and_crowding_match_jax(p):
    rng = np.random.default_rng(p)
    objs = (rng.integers(0, 12, (p, 2)) / 11).astype(np.float32)
    objs[::7, 1] += np.float32(1e-3)          # some off-grid values
    j_rank = np.asarray(j_nsga2.non_dominated_sort(jnp.asarray(objs)))
    t_rank = t_nsga2.non_dominated_sort(torch.as_tensor(objs))
    assert t_rank.dtype == torch.int32
    np.testing.assert_array_equal(t_rank.numpy(), j_rank)
    j_crowd = np.asarray(j_nsga2.crowding_distance(jnp.asarray(objs),
                                                   jnp.asarray(j_rank)))
    t_crowd = t_nsga2.crowding_distance(torch.as_tensor(objs), t_rank)
    np.testing.assert_array_equal(t_crowd.numpy(), j_crowd)
    # survivors: rank ascending, crowding descending, stable
    key = j_rank.astype(np.float32) * np.float32(1e9) - np.minimum(
        j_crowd, np.float32(5e8))
    j_keep = np.asarray(jnp.argsort(jnp.asarray(key)))[:p // 2]
    _, _, t_keep = t_nsga2.survivors(torch.as_tensor(objs), p // 2)
    np.testing.assert_array_equal(t_keep.numpy(), j_keep)


def _sort_objs(name):
    """Objectives of the sort's edge cases, made with numpy."""
    rng = np.random.default_rng(len(name) + 7)
    if name == "chain 300":      # each point dominates the next: 300 fronts
        v = rng.permutation(300).astype(np.float32)
        return np.stack([v / 3, v], 1)
    if name == "duplicates 64":  # 16 distinct points, four copies each
        base = (rng.integers(0, 5, (16, 2)) / 4).astype(np.float32)
        return rng.permutation(np.repeat(base, 4, axis=0))
    p, m, levels = {"ties 200": (200, 2, 6), "ragged 77": (77, 2, 20),
                    "ragged 161 M=3": (161, 3, 5),
                    "pool 1500": (1500, 2, 64)}[name]
    return (rng.integers(0, levels, (p, m)) / (levels - 1)).astype(np.float32)


@pytest.mark.parametrize("name", ["duplicates 64", "ties 200", "chain 300",
                                  "ragged 77", "ragged 161 M=3", "pool 1500"])
def test_non_dominated_sort_matches_jax(name):
    """Ties, duplicate points, a 300-front chain, pools that are not a
    multiple of 32 and one above the card's shared-memory relation (1500):
    the port's sort gives the reference's ranks element for element."""
    objs = _sort_objs(name)
    want = np.asarray(j_nsga2.non_dominated_sort(jnp.asarray(objs)))
    got = t_nsga2.non_dominated_sort(torch.as_tensor(objs))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "chain 300":
        assert want.max() == 299
    if name == "duplicates 64":   # copies never dominate each other
        for i in range(len(objs)):
            same = (objs == objs[i]).all(1)
            assert (want[same] == want[i]).all()


def _jax_step_draws(key, p, g):
    """The random numbers JAX `make_step` draws from ``key``."""
    _, ksel, kx, km = jax.random.split(key, 4)
    k1, k2 = jax.random.split(ksel)
    ku, kc, kv = jax.random.split(kx, 3)
    km2, ku2 = jax.random.split(km)
    a = lambda x: torch.as_tensor(np.array(x))
    return t_nsga2.StepDraws(
        tour_a=a(jax.random.randint(k1, (p,), 0, p)).long(),
        tour_b=a(jax.random.randint(k2, (p,), 0, p)).long(),
        sbx_u=a(jax.random.uniform(ku, (p // 2, g))),
        sbx_do=a(jax.random.uniform(kc, (p // 2,))),
        sbx_swap=a(jax.random.uniform(kv, (p // 2, g))),
        mut_u=a(jax.random.uniform(ku2, (p, g))),
        mut_mask=a(jax.random.uniform(km2, (p, g))))


def test_make_step_matches_jax_given_its_draws(seeds):
    jp, _ = seeds
    j_fit = j_search.make_reference_fitness(jp)

    def fitness(genes):  # the reference objectives, so only NSGA-II differs
        return torch.as_tensor(np.asarray(j_fit(jnp.asarray(genes.numpy()))))

    p, g = 32, jp.n_genes
    cfg_j = j_nsga2.NSGA2Config(pop_size=p)
    state = j_nsga2.init_state(jax.random.PRNGKey(3), j_fit, g, cfg_j,
                               seed_genes=jp.exact_genes())
    step_j = jax.jit(j_nsga2.make_step(j_fit, cfg_j))
    step_t = t_nsga2.make_step(fitness, t_nsga2.NSGA2Config(pop_size=p))
    t_state = convert.nsga2_state_from_arrays(
        {k: np.asarray(getattr(state, k)) for k in
         ("genes", "objs", "rank", "crowd", "generation")}, device="cpu")
    for _ in range(3):
        draws = _jax_step_draws(state.key, p, g)
        state = step_j(state)
        t_state = step_t(t_state, draws)
        np.testing.assert_allclose(t_state.genes.numpy(),
                                   np.asarray(state.genes), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(t_state.objs.numpy(),
                                      np.asarray(state.objs))
        np.testing.assert_array_equal(t_state.rank.numpy(),
                                      np.asarray(state.rank))
        np.testing.assert_array_equal(t_state.crowd.numpy(),
                                      np.asarray(state.crowd))
        assert t_state.generation == int(state.generation)
        # continue from the reference state so ulp drift cannot accumulate
        t_state = convert.nsga2_state_from_arrays(
            {k: np.asarray(getattr(state, k)) for k in
             ("genes", "objs", "rank", "crowd", "generation")}, device="cpu")


def test_init_state_injects_pristine_seed(seeds):
    _, tp = seeds
    fit = t_search.make_reference_fitness(tp)
    cfg = t_nsga2.NSGA2Config(pop_size=16)
    gen = torch.Generator().manual_seed(0)
    draws = t_nsga2.draw_init(gen, 16, tp.n_genes, 1, "cpu")
    state = t_nsga2.init_state(fit, cfg, draws, seed_genes=tp.exact_genes())
    np.testing.assert_array_equal(state.genes[0].numpy(), tp.exact_genes())
    assert state.objs[0].tolist() == [0.0, 1.0]
    assert t_nsga2.n_seeded(16, 1) == 2       # one pristine, one jittered
    assert not torch.equal(state.genes[1], state.genes[0])
    assert float((state.genes[1] - state.genes[0]).abs().max()) < 0.3


def test_seeds_run_kernel_backend(seeds, tmp_path):
    jp, tp = seeds
    result = t_search.run_search(tp, backend="kernel", pop_size=16,
                                 n_generations=3, out_dir=str(tmp_path),
                                 dataset="seeds", emit_rtl=True,
                                 verify_rtl=True)
    objs = result.pareto_objs
    # one dispatch for the initial population, one for the one chunk of
    # three generations (the JAX engine's count for this run)
    assert result.n_dispatches == 2 and result.n_evaluations == 64
    # the injected exact design (0, 1) is on the front or dominated by it
    assert ((objs[:, 0] <= 0.0) & (objs[:, 1] <= 1.0)).any()
    recomputed = _jax_objectives(jp, result.pareto_genes)
    np.testing.assert_array_equal(objs[:, 0], recomputed[:, 0])
    np.testing.assert_allclose(objs[:, 1], recomputed[:, 1], rtol=1e-6)
    # the port's pareto.json loads and validates through the JAX loader
    art = j_search.load_pareto_artifact(str(tmp_path / "pareto.json"))
    assert len(art.points) == len(objs) and art.payload["rtl_verified"]
    assert art.payload["n_dispatches"] == 2
    ptrees = art.ptrees()
    for i, point in enumerate(art.points):
        bits, t_int, trunc, vote_adder = art.point_design(i)
        verilog = j_rtl.emit_design(ptrees, bits, t_int, art.n_classes,
                                    trunc=trunc, vote_adder=vote_adder)
        assert (tmp_path / point["rtl"]).read_text() == verilog
        circuit = j_netlist.build_circuit(ptrees, bits, t_int, art.n_classes,
                                          trunc=trunc, vote_adder=vote_adder)
        assert point["netlist_gates"] == j_netlist.gate_counts(circuit)
        assert point["area_netlist_mm2"] == round(
            j_netlist.netlist_area_mm2(circuit), 4)


def _designs(tp, n, seed):
    rng = np.random.default_rng(seed)
    genes = torch.as_tensor(_random_pop(tp, n, seed))
    bits, margin, trunc, vote = t_quant.decode_tree_genes(genes)
    t_sub = t_quant.substitute(t_quant.threshold_to_int(tp.threshold, bits),
                               margin, bits)
    for i in range(n):
        yield (bits[i].numpy(), t_sub[i].numpy(),
               trunc[i].numpy() if rng.random() < 0.5 else None,
               "approx" if int(vote[i]) else "exact")


@pytest.mark.parametrize("name", ["seeds", "balance"])
def test_netlist_and_verilog_match_jax(name):
    jp, tp = _problems(name)
    j_pt = j_search.problem_ptrees(jp)
    t_pt = t_search.problem_ptrees(tp)
    rng = np.random.default_rng(0)
    x8 = np.concatenate([tp.x8.numpy(),
                         rng.integers(0, 256, (50, tp.n_features))]).astype(
                             np.int32)
    for i, (bits, t_sub, trunc, vote_adder) in enumerate(
            _designs(tp, 8, len(name))):
        jc = j_netlist.build_circuit(j_pt, bits, t_sub, jp.n_classes,
                                     trunc=trunc, vote_adder=vote_adder)
        tc = t_netlist.build_circuit(t_pt, bits, t_sub, tp.n_classes,
                                     trunc=trunc, vote_adder=vote_adder)
        for f in ("op", "a", "b"):
            np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
        assert tc.out_bits == jc.out_bits
        np.testing.assert_array_equal(t_netlist.levelize(tc),
                                      j_netlist.levelize(jc))
        assert t_netlist.gate_counts(tc) == j_netlist.gate_counts(jc)
        assert t_netlist.netlist_area_mm2(tc) == j_netlist.netlist_area_mm2(jc)
        sim = t_netlist.simulate(tc, torch.as_tensor(x8))
        assert sim.dtype == torch.int32
        np.testing.assert_array_equal(
            sim.numpy(), j_faults.simulate_faulty_serial(jc, x8))
        if i < 2:  # the jnp simulator compiles per circuit, seconds each
            np.testing.assert_array_equal(
                sim.numpy(), np.asarray(j_netlist.simulate(jc, x8)))
        assert (t_rtl.emit_design(t_pt, bits, t_sub, tp.n_classes,
                                  trunc=trunc, vote_adder=vote_adder)
                == j_rtl.emit_design(j_pt, bits, t_sub, jp.n_classes,
                                     trunc=trunc, vote_adder=vote_adder))


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_default_device_entry_points_raise_without_gpu(monkeypatch, seeds):
    _, tp = seeds
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = load_dataset("seeds")
    pt = t_search.problem_ptrees(tp)[0]
    with pytest.raises(CudaUnavailableError):
        t_search.build_problem(pt, ds.x_test, ds.y_test)
    from repro_torch.runtime.classify import ClassifyServer
    with pytest.raises(CudaUnavailableError):
        ClassifyServer([pt], np.full(pt.n_comparators, 8), np.zeros(
            pt.n_comparators), pt.n_classes)
    with pytest.raises(CudaUnavailableError):
        convert.nsga2_state_from_arrays({"genes": np.zeros((2, 4)),
                                         "objs": np.zeros((2, 2)),
                                         "rank": np.zeros(2),
                                         "crowd": np.zeros(2),
                                         "generation": 0})


@pytest.mark.parametrize("argv", [
    ["--backend", "islands"], ["--mesh", "4"], ["sweep"],
    ["faults", "--pareto", "x.json"],
])
def test_cli_refuses_unported_surfaces(argv):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.search", *argv, "--device", "cpu"]
        if argv[0] not in ("sweep", "faults") else
        [sys.executable, "-m", "repro_torch.search", *argv],
        capture_output=True, text=True, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")}, timeout=120)
    assert proc.returncode == 2, proc.stderr
    lines = proc.stderr.strip().splitlines()
    assert len(lines) == 1 and "ROADMAP.md Queue 1 item" in lines[0]
