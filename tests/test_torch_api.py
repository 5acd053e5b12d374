"""The public functions of ported modules that the port gained after their
modules (the matmul-form tree oracle, the Fig. 3a gene layout, the
truncated-comparator, MAC, activation and delay models, the NSGA-II
driver `run`, `nsga2.domination_matrix` and `problem.vote_area_mm2`), each
held to its JAX function on the CPU.

Tolerances: integers (decisions, leaves, classes, bits, margins, gate
counts, the domination relation) exactly; areas and delays, which both
packages compute in the same float64 Python arithmetic, exactly; the vote
area in float32, exactly (both round the same whole-quanta mm^2 once).
`nsga2.run` cannot replay `jax.random`, so it is held to the port's own
`init_state` / `make_step` loop on the same generator, array for array,
and, like the JAX package's `run`, must keep a front point that matches or
dominates the exact design (0, 1).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import search as j_search
from repro.core import area as j_area
from repro.core import forest as j_forest
from repro.core import nsga2 as j_nsga2
from repro.core import quant as j_quant
from repro.core import train as j_train
from repro.core import tree as j_tree
from repro.search import backends as j_backends
from repro.search import problem as j_problem
from repro_torch import search as t_search
from repro_torch.core import area as t_area
from repro_torch.core import forest as t_forest
from repro_torch.core import nsga2 as t_nsga2
from repro_torch.core import quant as t_quant
from repro_torch.core import train as t_train
from repro_torch.core import tree as t_tree
from repro_torch.datasets import load_dataset
from repro_torch.search import problem as t_problem


@pytest.fixture(scope="module")
def seeds_tree():
    ds = load_dataset("seeds")
    pj = j_tree.to_parallel(j_train.train_tree(ds.x_train, ds.y_train,
                                               ds.n_classes))
    pt = t_tree.to_parallel(t_train.train_tree(ds.x_train, ds.y_train,
                                               ds.n_classes))
    x8 = np.asarray(t_search.build_tree_problem(pt, ds.x_test, ds.y_test,
                                                device="cpu").x8)
    return ds, pj, pt, x8


def _fields(pt):
    return {k: getattr(pt, k) for k in ("feature", "threshold", "path",
                                        "path_len", "n_neg", "leaf_class")}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matmul_form_oracle_matches_jax(seeds_tree, seed):
    """`decisions_quantized`, `leaves_from_decisions` and
    `predict_quantized` on the seeds tree at random precisions and
    margins (seed 0: the exact design)."""
    _, pj, pt, x8 = seeds_tree
    for k, v in _fields(pt).items():
        np.testing.assert_array_equal(v, getattr(pj, k))
    rng = np.random.default_rng(seed)
    n = pt.n_comparators
    bits = (np.full(n, 8) if seed == 0 else rng.integers(2, 9, n)).astype(
        np.int32)
    margin = (np.zeros(n) if seed == 0 else rng.integers(-5, 6, n)).astype(
        np.int32)
    arrays_j = j_tree.ptree_to_jnp(pj)
    arrays_t = {k: torch.as_tensor(v) for k, v in _fields(pt).items()}
    d_j = j_tree.decisions_quantized(jnp.asarray(x8), arrays_j["feature"],
                                     arrays_j["threshold"], jnp.asarray(bits),
                                     jnp.asarray(margin))
    d_t = t_tree.decisions_quantized(torch.as_tensor(x8), arrays_t["feature"],
                                     arrays_t["threshold"],
                                     torch.as_tensor(bits),
                                     torch.as_tensor(margin))
    assert d_t.dtype == torch.bool
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    leaf_j = j_tree.leaves_from_decisions(d_j, arrays_j["path"],
                                          arrays_j["path_len"])
    leaf_t = t_tree.leaves_from_decisions(d_t, arrays_t["path"],
                                          arrays_t["path_len"])
    np.testing.assert_array_equal(leaf_t.numpy(), np.asarray(leaf_j))
    pred_j = j_tree.predict_quantized(jnp.asarray(x8), arrays_j,
                                      jnp.asarray(bits), jnp.asarray(margin))
    pred_t = t_tree.predict_quantized(torch.as_tensor(x8), arrays_t,
                                      torch.as_tensor(bits),
                                      torch.as_tensor(margin))
    np.testing.assert_array_equal(pred_t.numpy(), np.asarray(pred_j))


def test_leaves_take_the_first_maximum():
    """Decisions that satisfy no leaf or several leaves tie in the score;
    both packages take the first maximum."""
    rng = np.random.default_rng(3)
    path = rng.integers(-1, 2, (9, 12)).astype(np.int8)
    path[4] = path[2]                                 # a duplicate leaf
    path_len = (path != 0).sum(1).astype(np.int32)
    d = rng.integers(0, 2, (64, 12)).astype(bool)
    want = j_tree.leaves_from_decisions(jnp.asarray(d), jnp.asarray(path),
                                        jnp.asarray(path_len))
    got = t_tree.leaves_from_decisions(torch.as_tensor(d),
                                       torch.as_tensor(path),
                                       torch.as_tensor(path_len))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((got == 4).sum()) == 0


def test_fig3a_genes_match_jax():
    rng = np.random.default_rng(4)
    genes = rng.random((16, 2 * 37)).astype(np.float32)
    genes[0] = 0.0
    genes[1] = 1.0
    genes[2] = np.nextafter(np.float32(1.0), np.float32(0.0))
    bits_j, margin_j = j_quant.decode_genes(jnp.asarray(genes))
    bits_t, margin_t = t_quant.decode_genes(torch.as_tensor(genes))
    assert bits_t.dtype == margin_t.dtype == torch.int32
    np.testing.assert_array_equal(bits_t.numpy(), np.asarray(bits_j))
    np.testing.assert_array_equal(margin_t.numpy(), np.asarray(margin_j))
    np.testing.assert_array_equal(t_quant.exact_genes(37),
                                  j_quant.exact_genes(37))
    bits, margin = t_quant.decode_genes(torch.as_tensor(
        t_quant.exact_genes(37)))
    assert bool((bits == 8).all()) and not margin.any()


def test_area_and_delay_models_match_jax():
    for p in range(0, 9):
        for t in range(1 << p):
            for k in range(4):
                assert (t_area.trunc_comparator_gate_counts(t, p, k)
                        == j_area.trunc_comparator_gate_counts(t, p, k))
                assert (t_area.trunc_comparator_area_mm2(t, p, k)
                        == j_area.trunc_comparator_area_mm2(t, p, k))
    for code in range(-8, 8):
        for in_bits in range(1, 9):
            assert (t_area.mac_area_mm2(code, in_bits)
                    == j_area.mac_area_mm2(code, in_bits))
    for acc_bits in range(0, 25):
        assert t_area.act_area_mm2(acc_bits) == j_area.act_area_mm2(acc_bits)
    assert (t_area.DELAY_BASE_MS, t_area.DELAY_PER_COMP_MS) == (
        j_area.DELAY_BASE_MS, j_area.DELAY_PER_COMP_MS)
    for n in (0, 1, 7, 588, 2227, 4096):
        assert t_area.delay_ms(n) == j_area.delay_ms(n)


@pytest.mark.parametrize("n_trees", [1, 3])
def test_vote_area_matches_jax(n_trees):
    """The vote stage's mm^2 for both adder modes, from the port's int32
    caps and from the JAX package's float caps (1 approximate, inf exact);
    0 for a single tree."""
    ds = load_dataset("vertebral")
    if n_trees == 1:
        jp = j_search.build_tree_problem(
            j_tree.to_parallel(j_train.train_tree(
                ds.x_train, ds.y_train, ds.n_classes)), ds.x_test, ds.y_test)
        tp = t_search.build_tree_problem(
            t_tree.to_parallel(t_train.train_tree(
                ds.x_train, ds.y_train, ds.n_classes)), ds.x_test, ds.y_test,
            device="cpu")
    else:
        jp = j_search.build_forest_problem(
            j_forest.train_forest(ds.x_train, ds.y_train, ds.n_classes,
                                  n_trees=n_trees), ds.x_test, ds.y_test)
        tp = t_search.build_forest_problem(
            t_forest.train_forest(ds.x_train, ds.y_train, ds.n_classes,
                                  n_trees=n_trees), ds.x_test, ds.y_test,
            device="cpu")
    want = np.asarray(j_problem.vote_area_mm2(
        jp, jnp.asarray([1.0, np.inf], jnp.float32)))
    for caps in (torch.tensor([1, t_quant.NO_VOTE_CAP], dtype=torch.int32),
                 torch.tensor([1.0, float("inf")])):
        got = t_problem.vote_area_mm2(tp, caps)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).all() == (n_trees == 1)


def test_domination_matrix_matches_jax():
    rng = np.random.default_rng(5)
    objs = rng.integers(0, 4, (40, 2)).astype(np.float32)   # many ties
    against = rng.integers(0, 4, (25, 2)).astype(np.float32)
    for a in (None, against):
        want = j_nsga2.domination_matrix(
            jnp.asarray(objs), None if a is None else jnp.asarray(a))
        got = t_nsga2.domination_matrix(
            torch.as_tensor(objs), None if a is None else torch.as_tensor(a))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nsga2_run_drives_init_and_steps():
    """`run` equals `init_state` and `make_step` fed by `draw_init` /
    `draw_step` from the same generator, and continuing from a state
    equals the uninterrupted run; on the seeds tree both packages' `run`
    keep a front point that matches or dominates the exact design."""
    ds = load_dataset("seeds")
    pt = t_tree.to_parallel(t_train.train_tree(ds.x_train, ds.y_train,
                                               ds.n_classes))
    tp = t_search.build_tree_problem(pt, ds.x_test, ds.y_test, device="cpu")

    def fitness(genes):
        return t_problem.objectives(tp, genes)

    cfg = t_nsga2.NSGA2Config(pop_size=16, n_generations=4)
    seed = tp.exact_genes()
    got = t_nsga2.run(torch.Generator().manual_seed(7), fitness, tp.n_genes,
                      cfg, seed_genes=seed)

    gen = torch.Generator().manual_seed(7)
    state = t_nsga2.init_state(fitness, cfg, t_nsga2.draw_init(
        gen, cfg.pop_size, tp.n_genes, 1, "cpu"), seed)
    step = t_nsga2.make_step(fitness, cfg)
    for _ in range(cfg.n_generations):
        state = step(state, t_nsga2.draw_step(gen, cfg.pop_size, tp.n_genes,
                                              "cpu"))
    assert got.generation == state.generation == 4
    for f in ("genes", "objs", "rank", "crowd"):
        assert torch.equal(getattr(got, f), getattr(state, f)), f

    gen = torch.Generator().manual_seed(7)
    half = t_nsga2.NSGA2Config(pop_size=16, n_generations=2)
    mid = t_nsga2.run(gen, fitness, tp.n_genes, half, seed_genes=seed)
    end = t_nsga2.run(gen, fitness, tp.n_genes, half, state=mid)
    for f in ("genes", "objs", "rank", "crowd"):
        assert torch.equal(getattr(end, f), getattr(got, f)), f

    objs, _ = t_nsga2.pareto_front(got.objs, got.genes)
    assert ((objs[:, 0] <= 0) & (objs[:, 1] <= 1)).any()

    pj = j_tree.to_parallel(j_train.train_tree(ds.x_train, ds.y_train,
                                               ds.n_classes))
    jp = j_search.build_tree_problem(pj, ds.x_test, ds.y_test)
    j_cfg = j_nsga2.NSGA2Config(pop_size=16, n_generations=4)
    j_state = j_nsga2.run(jax.random.PRNGKey(7),
                          j_backends.make_reference_fitness(jp),
                          jp.n_genes, j_cfg, seed_genes=jp.exact_genes())
    j_objs, _ = j_nsga2.pareto_front(j_state.objs, j_state.genes)
    assert ((j_objs[:, 0] <= 0) & (j_objs[:, 1] <= 1 + 1e-6)).any()
