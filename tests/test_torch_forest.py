"""Parity of the port's forests (`--trees K`) with the JAX package, on the
CPU: training, the block-diagonal operands, votes, objectives, area, the
vote adders, netlists and Verilog, the plain versions of the two tree
kernels on forest and wide operands, serving and the CLI.

Tolerances: exact equality, except the area objective, which the port
holds to integer quanta (exact in any order) while the JAX package sums the
float mm^2 LUT in float32: they agree to 1e-6 relative (ROADMAP Queue 3,
"Area objective"), and the port's value equals an independent integer
quanta sum exactly. The accuracy objective is held to the reference's
un-jitted `objectives`.
"""
from __future__ import annotations

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
from repro.core import area as j_area
from repro.core import faults as j_faults
from repro.core import forest as j_forest
from repro.core import netlist as j_netlist
from repro.core import quant as j_quant
from repro.core import rtl as j_rtl
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.runtime.classify import ClassifyServer as JClassifyServer
from repro_torch import convert
from repro_torch import search as t_search
from repro_torch.core import approx as t_approx
from repro_torch.core import area as t_area
from repro_torch.core import forest as t_forest
from repro_torch.core import netlist as t_netlist
from repro_torch.core import quant as t_quant
from repro_torch.core import rtl as t_rtl
from repro_torch.core import tree as t_tree
from repro_torch.datasets import load_dataset
from repro_torch.kernels import fitness as t_fit
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import tree_infer as t_ti
from repro_torch.runtime.classify import ClassifyServer

REPO = pathlib.Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _forests(name: str, k: int):
    """(JAX forest, port forest, JAX problem, port problem) of dataset
    ``name`` with ``k`` trees."""
    ds = load_dataset(name)
    jf = j_forest.train_forest(ds.x_train, ds.y_train, ds.n_classes,
                               n_trees=k)
    tf = t_forest.train_forest(ds.x_train, ds.y_train, ds.n_classes,
                               n_trees=k)
    jp = j_search.build_forest_problem(jf, ds.x_test, ds.y_test)
    tp = t_search.build_forest_problem(tf, ds.x_test, ds.y_test, device="cpu")
    return jf, tf, jp, tp


def _random_pop(problem, n, seed):
    """Random chromosomes with the truncation and vote genes live: the
    exact design first, then near-exact ones, then uniform ones."""
    rng = np.random.default_rng(seed)
    genes = rng.random((n, problem.n_genes), dtype=np.float32)
    exact = problem.exact_genes()
    genes[0] = exact
    for i in range(1, n // 2):
        g = exact.copy()
        idx = rng.integers(0, problem.n_genes - 1, 4)
        g[idx] = rng.random(4, dtype=np.float32)
        g[-1] = rng.random(dtype=np.float32)      # vote adder either way
        genes[i] = g
    return genes


@pytest.mark.parametrize("name,k", [("seeds", 4), ("vertebral", 2),
                                    ("vertebral", 4)])
def test_train_forest_matches_jax(name, k):
    jf, tf, jp, tp = _forests(name, k)
    assert tf.n_classes == jf.n_classes and tf.n_genes == jf.n_genes
    assert len(tf.trees) == len(jf.trees) == k
    for jt, tt in zip(jf.trees, tf.trees):
        for f in ("feature", "threshold", "left", "right", "leaf_class"):
            np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f))
    for jt, tt in zip(jf.ptrees, tf.ptrees):
        for f in ("feature", "threshold", "path", "path_len", "n_neg",
                  "leaf_class"):
            np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f))
    for f in ("n_trees", "tree_comparators", "tree_leaves", "n_genes",
              "n_classes"):
        assert getattr(tp, f) == getattr(jp, f)
    assert tp.exact_accuracy == jp.exact_accuracy
    assert tp.exact_area_mm2 == pytest.approx(jp.exact_area_mm2, rel=1e-6)
    assert tp.vote_units_exact * t_area.AREA_QUANTUM_MM2 == pytest.approx(
        jp.vote_mm2_exact, rel=1e-12)
    assert tp.vote_units_approx * t_area.AREA_QUANTUM_MM2 == pytest.approx(
        jp.vote_mm2_approx, rel=1e-12)


def test_forest_problem_from_jax_arrays():
    """`convert.problem_from_arrays` rebuilds the forest problem the port
    builds itself, vote adders included."""
    _, _, jp, tp = _forests("seeds", 4)
    fields = {f: np.asarray(getattr(jp, f)) for f in (
        "feature", "threshold", "path", "path_len", "n_neg", "leaf_class",
        "leaf_tree", "x8", "x_sel", "y", "area_lut", "lut_offsets")}
    scalars = {s: getattr(jp, s) for s in (
        "overhead_mm2", "exact_accuracy", "n_classes", "n_features",
        "n_trees", "tree_comparators", "tree_leaves", "vote_mm2_exact",
        "vote_mm2_approx")}
    cp = convert.problem_from_arrays(fields, scalars, device="cpu")
    for f in ("n_trees", "vote_units_exact", "vote_units_approx",
              "exact_units", "overhead_units", "tree_comparators"):
        assert getattr(cp, f) == getattr(tp, f), f
    for f in ("feature", "path", "leaf_tree", "x_sel"):
        assert torch.equal(getattr(cp, f), getattr(tp, f)), f


def test_prepare_forest_operands_match_jax():
    jf, tf, jp, tp = _forests("seeds", 4)
    sel, path_t, target, cls1h = (np.asarray(a) for a in
                                  j_ops.prepare_forest_operands(
                                      jf.ptrees, tp.n_features))
    ops = t_ops.prepare_forest_operands(tf.ptrees, tp.n_features,
                                        device="cpu")
    n, l = tp.n_comparators, tp.n_leaves
    np.testing.assert_array_equal(ops.path.numpy(), path_t[:n, :l].T)
    np.testing.assert_array_equal(ops.target.numpy(), target[0, :l])
    np.testing.assert_array_equal(ops.leaf_class.numpy(),
                                  cls1h[:l].argmax(1))
    np.testing.assert_array_equal(ops.feature.numpy(), sel[:, :n].argmax(0))
    # the K = 1 case is the single tree's operands
    one = t_ops.prepare_tree_operands(tf.ptrees[0], tp.n_features,
                                      device="cpu")
    j_one = np.asarray(j_ops.prepare_tree_operands(jf.ptrees[0],
                                                   tp.n_features)[1])
    n0, l0 = tf.ptrees[0].n_comparators, tf.ptrees[0].n_leaves
    np.testing.assert_array_equal(one.path.numpy(), j_one[:n0, :l0].T)


@pytest.mark.parametrize("name,k", [("seeds", 4), ("vertebral", 2)])
def test_forest_predict_votes_match_jax(name, k):
    """The block-diagonal dataflow equals JAX `predict_votes` for random
    genes with the truncation and vote genes live, and (truncation off,
    exact adder) the port's per-tree oracle `forest_predict`."""
    jf, tf, jp, tp = _forests(name, k)
    genes = _random_pop(tp, 24, k)
    for g in genes:
        bits, t_sub, cap = t_search.decode_chromosome(tp, torch.as_tensor(g))
        got = t_search.predict_votes(tp, bits, t_sub, cap).numpy()
        jb, jt, jc = j_search.problem.decode_chromosome(jp, jnp.asarray(g))
        want = np.asarray(j_search.predict_votes(jp, jb, jt, jc))
        np.testing.assert_array_equal(got, want)
        g0 = g.copy()
        g0[2:-1:3] = 0.0      # no truncation
        g0[-1] = 0.0          # exact vote adder
        bits, margin, _, _ = t_quant.decode_tree_genes(torch.as_tensor(g0))
        oracle = t_forest.forest_predict(tf, tp.x8, bits, margin).numpy()
        b0, t0, c0 = t_search.decode_chromosome(tp, torch.as_tensor(g0))
        np.testing.assert_array_equal(
            t_search.predict_votes(tp, b0, t0, c0).numpy(), oracle)
        np.testing.assert_array_equal(oracle, np.asarray(
            j_forest.forest_predict(jf, jnp.asarray(tp.x8.numpy()),
                                    jnp.asarray(bits.numpy()),
                                    jnp.asarray(margin.numpy()))))


@pytest.mark.parametrize("name,k", [("seeds", 4), ("vertebral", 4)])
def test_forest_objectives_match_jax(name, k):
    """Loss exact against the un-jitted reference; area within 1e-6 of it
    and exactly the integer-quanta sum, vote adder included; the kernel
    backend (its plain version here) equals the reference backend."""
    _, _, jp, tp = _forests(name, k)
    genes = _random_pop(tp, 32, k + 1)
    got = t_search.objectives(tp, torch.as_tensor(genes)).numpy()
    want = np.asarray(jax.vmap(functools.partial(j_search.problem.objectives,
                                                 jp))(jnp.asarray(genes)))
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-6)
    assert got[0].tolist() == [0.0, 1.0]
    lut, off = t_area.build_area_unit_lut()
    bits, t_sub, cap = (x.numpy() for x in t_search.decode_chromosome(
        tp, torch.as_tensor(genes)))
    units = (lut[off[bits] + t_sub].astype(np.int64).sum(-1)
             + tp.overhead_units
             + np.where(cap == 1, tp.vote_units_approx, tp.vote_units_exact))
    np.testing.assert_array_equal(
        got[:, 1], units.astype(np.float32) / np.float32(tp.exact_units))
    kern = t_search.make_kernel_fitness(tp)(torch.as_tensor(genes))
    assert torch.equal(kern, torch.as_tensor(got))
    one = torch.as_tensor(genes[1])
    assert float(t_search.chromosome_accuracy(tp, one)) == float(
        j_search.problem.chromosome_accuracy(jp, jnp.asarray(genes[1])))
    assert t_search.chromosome_area_mm2(tp, one) == pytest.approx(float(
        j_search.problem.chromosome_area_mm2(jp, jnp.asarray(genes[1]))),
        rel=1e-6)


def test_forest_area_and_vote_adders_match_jax():
    jf, tf, jp, tp = _forests("seeds", 4)
    rng = np.random.default_rng(3)
    for _ in range(4):
        bits = rng.integers(2, 9, tp.n_comparators)
        marg = rng.integers(-5, 6, tp.n_comparators)
        for dedup in (True, False):
            assert t_forest.forest_area_mm2(tf, bits, marg, dedup=dedup) == \
                j_forest.forest_area_mm2(jf, bits, marg, dedup=dedup)
    for k in (1, 2, 3, 4, 5, 8):
        for c in (2, 3, 6, 10):
            for approx in (False, True):
                assert t_area.vote_adder_units(k, c, approx) == \
                    j_area.vote_adder_units(k, c, approx)
                assert t_area.vote_adder_area_mm2(k, c, approx) == \
                    j_area.vote_adder_area_mm2(k, c, approx)
                if k > 1:
                    assert t_netlist.vote_adder_gate_counts(k, c, approx) \
                        == j_netlist.vote_adder_gate_counts(k, c, approx)
    ds = load_dataset("seeds")
    fit, acc, area = t_forest.make_forest_fitness(tf, ds.x_test, ds.y_test,
                                                  device="cpu")
    assert acc == jp.exact_accuracy
    assert area == pytest.approx(jp.exact_area_mm2, rel=1e-6)
    assert fit(torch.as_tensor(tp.exact_genes()[None])).tolist() == [[0.0,
                                                                      1.0]]


def _designs(tp, n, seed):
    rng = np.random.default_rng(seed)
    genes = torch.as_tensor(_random_pop(tp, n, seed))
    bits, margin, trunc, vote = t_quant.decode_tree_genes(genes)
    t_sub = t_quant.substitute(t_quant.threshold_to_int(tp.threshold, bits),
                               margin, bits)
    for i in range(n):
        yield (bits[i].numpy(), t_sub[i].numpy(),
               trunc[i].numpy() if rng.random() < 0.5 else None,
               "approx" if i % 2 else "exact")


def test_forest_netlist_and_verilog_match_jax():
    """A seeds K=4 forest's circuits (both vote adders) equal JAX's gate for
    gate, simulate to the same classes, and print the same Verilog."""
    jf, tf, jp, tp = _forests("seeds", 4)
    j_pt = j_search.problem_ptrees(jp)
    t_pt = t_search.problem_ptrees(tp)
    assert len(t_pt) == 4
    rng = np.random.default_rng(0)
    x8 = np.concatenate([tp.x8.numpy(), rng.integers(
        0, 256, (50, tp.n_features))]).astype(np.int32)
    for i, (bits, t_sub, trunc, vote_adder) in enumerate(_designs(tp, 8, 1)):
        jc = j_netlist.build_circuit(j_pt, bits, t_sub, jp.n_classes,
                                     trunc=trunc, vote_adder=vote_adder)
        tc = t_netlist.build_circuit(t_pt, bits, t_sub, tp.n_classes,
                                     trunc=trunc, vote_adder=vote_adder)
        for f in ("op", "a", "b"):
            np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
        assert tc.out_bits == jc.out_bits and tc.n_trees == 4
        assert t_netlist.gate_counts(tc) == j_netlist.gate_counts(jc)
        sim = t_netlist.simulate(tc, torch.as_tensor(x8)).numpy()
        np.testing.assert_array_equal(sim,
                                      j_faults.simulate_faulty_serial(jc, x8))
        cap = torch.full((), 1 if vote_adder == "approx" else
                         t_quant.NO_VOTE_CAP, dtype=torch.int32)
        k = torch.zeros_like(torch.as_tensor(bits)) if trunc is None \
            else torch.as_tensor(trunc)
        pred = t_search.predict_votes(
            tp, torch.as_tensor(bits) - k, torch.as_tensor(t_sub) >> k, cap)
        np.testing.assert_array_equal(sim[:tp.x8.shape[0]], pred.numpy())
        verilog = t_rtl.emit_design(t_pt, bits, t_sub, tp.n_classes,
                                    trunc=trunc, vote_adder=vote_adder)
        assert verilog == j_rtl.emit_design(j_pt, bits, t_sub, jp.n_classes,
                                            trunc=trunc,
                                            vote_adder=vote_adder)
        assert verilog == t_rtl.emit_forest_verilog(
            t_pt, bits, t_sub, tp.n_classes, trunc=trunc,
            vote_adder=vote_adder)


def _forest_case(seed, widths, p, b, c, n_features=40):
    """Random chromosomes, codes and labels over the super-tree of random
    trees of ``widths`` comparators."""
    rng = np.random.default_rng(seed)
    trees = [t_tree.to_parallel(t_tree.random_tree(rng, w, n_features, c))
             for w in widths]
    arrays = t_tree.concatenate_ptrees(trees)
    n = arrays["feature"].shape[0]
    bits = rng.integers(0, 9, (p, n)).astype(np.int32)
    return dict(arrays=arrays, trees=trees,
                x8=rng.integers(0, 256, (b, n_features)).astype(np.int32),
                y=rng.integers(-1, c, b).astype(np.int32), bits=bits,
                thr=(rng.integers(0, 256, (p, n)) % (1 << bits))
                .astype(np.int32),
                approx=rng.random(p) < 0.5, c=c, n_features=n_features)


# (seed, tree widths): a forest like har's (five trees of 400-480
# comparators) and a single tree of N = 2500, past the old 2048 cap
WIDE_CASES = [(0, (473, 414, 482, 431, 427)), (1, (2500,))]


@pytest.mark.parametrize("seed,widths", WIDE_CASES)
def test_wide_plain_kernels_match_ref(seed, widths):
    """The plain versions of both widened kernels equal `repro.kernels.ref`
    on a forest's block-diagonal operands and on a wide single tree."""
    case = _forest_case(seed, widths, p=3, b=24, c=5)
    a = case["arrays"]
    n, l = a["path"].shape[1], a["path"].shape[0]
    c, nf = case["c"], case["n_features"]
    x_sel = case["x8"][:, a["feature"]]
    j_fit = j_ops.prepare_fitness_operands(
        x_sel, case["y"], a["path"], a["path_len"], a["n_neg"],
        a["leaf_class"], c)
    x_sel_p, path_t, target, cls1h, y_row = j_fit
    n_pad = x_sel_p.shape[1]
    scale = np.exp2(-(8 - case["bits"]).astype(np.float32))
    scale = np.pad(scale, ((0, 0), (0, n_pad - n)))
    thr = np.pad(case["thr"].astype(np.float32), ((0, 0), (0, n_pad - n)),
                 constant_values=256.0)
    cap = np.where(case["approx"], 1.0, np.inf).astype(np.float32)
    expect = np.asarray(j_ref.fitness_correct_counts(
        x_sel_p, jnp.asarray(scale), jnp.asarray(thr), path_t, target, cls1h,
        y_row, jnp.asarray(cap)))
    ops = t_ops.prepare_fitness_operands(
        torch.as_tensor(x_sel), case["y"], a["path"], a["path_len"],
        a["n_neg"], a["leaf_class"], c)
    shift = torch.as_tensor(8 - case["bits"])
    thr_t = torch.as_tensor(case["thr"])
    cap_t = torch.as_tensor(np.where(case["approx"], 1, t_quant.NO_VOTE_CAP)
                            .astype(np.int32))
    got = t_fit.fitness_correct_counts(ops, shift, thr_t, cap_t)
    np.testing.assert_array_equal(got.numpy(), expect.astype(np.int32))

    sel, path_t2, target2, cls1h2 = j_ops.prepare_operands(
        a["feature"], a["path"], a["path_len"], a["n_neg"], a["leaf_class"],
        c, nf)
    x8f = np.pad(case["x8"].astype(np.float32),
                 ((0, 0), (0, sel.shape[0] - nf)))
    scale2 = np.pad(np.exp2(-(8 - case["bits"]).astype(np.float32)),
                    ((0, 0), (0, sel.shape[1] - n)))
    thr2 = np.pad(case["thr"].astype(np.float32),
                  ((0, 0), (0, sel.shape[1] - n)), constant_values=256.0)
    want = np.asarray(j_ref.tree_infer_scores(
        jnp.asarray(x8f), sel, jnp.asarray(scale2), jnp.asarray(thr2),
        path_t2, target2, cls1h2))[:, :, :c]
    t_ops_ = t_ops.prepare_operands(a["feature"], a["path"], a["path_len"],
                                    a["n_neg"], a["leaf_class"], c, nf,
                                    device="cpu")
    votes = t_ti.tree_infer_scores(torch.as_tensor(case["x8"]), t_ops_,
                                   shift, thr_t)
    np.testing.assert_array_equal(votes.numpy(), want.astype(np.int32))
    assert t_ops_.n_seg * t_ops_.nwp * 32 < max(widths) + 8 * 32 + 2048


@pytest.mark.parametrize("vote_adder", ["exact", "approx"])
def test_forest_server_matches_jax(vote_adder):
    """`ClassifyServer` over K trees gives the JAX server's predictions
    (its reference backend: its kernel backend is a Pallas call) on both
    port backends, at several request sizes."""
    _, _, jp, tp = _forests("vertebral", 4)
    bits, t_sub, trunc, _ = next(_designs(tp, 3, 7))
    pts = t_search.problem_ptrees(tp)
    jserver = JClassifyServer(j_search.problem_ptrees(jp), bits, t_sub,
                              jp.n_classes, trunc=trunc,
                              vote_adder=vote_adder, backend="reference")
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 256, (100, tp.n_features)).astype(np.int32)
    want = np.asarray(jserver.classify_codes(codes))
    for backend in ("kernel", "reference"):
        server = ClassifyServer(pts, bits, t_sub, tp.n_classes,
                                trunc=trunc, vote_adder=vote_adder,
                                backend=backend, max_batch=64, device="cpu")
        for rows in (1, 37, 100):
            np.testing.assert_array_equal(server.classify_codes(codes[:rows]),
                                          want[:rows])


def test_approx_adapter_is_the_k1_problem():
    ds = load_dataset("seeds")
    pt = t_tree.to_parallel(
        t_forest.train_forest(ds.x_train, ds.y_train, ds.n_classes,
                              n_trees=1).trees[0])
    prob = t_approx.build_problem(pt, ds.x_test, ds.y_test, device="cpu")
    assert isinstance(prob, t_approx.ApproxProblem) and prob.n_trees == 1
    assert prob.vote_units_exact == prob.vote_units_approx == 0
    genes = torch.as_tensor(_random_pop(prob, 8, 0))
    assert torch.equal(t_approx.make_fitness_fn(prob)(genes),
                       t_approx.make_fitness_fn_kernel(prob)(genes))


def test_cli_forest_end_to_end(tmp_path):
    """`--trees 4 --verify-rtl --device cpu` with checkpoints writes a forest
    pareto.json; `--resume` continues from the saved step; serving the
    front reproduces the recorded accuracy against the netlist."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = tmp_path / "run"
    base = [sys.executable, "-m", "repro_torch.search", "--dataset", "seeds",
            "--trees", "4", "--backend", "kernel", "--pop", "16",
            "--checkpoint-every", "2", "--out", str(out), "--verify-rtl",
            "--device", "cpu"]

    def run(*extra):
        proc = subprocess.run([*base, *extra], capture_output=True, text=True,
                              cwd=REPO, env=env, timeout=300)
        assert proc.returncode == 0, proc.stderr
        return proc.stdout

    text = run("--gens", "4")
    assert "forest[4]: comparators=" in text and "RTL verified" in text
    assert "3 device dispatches" in text
    art = t_search.load_pareto_artifact(str(out / "pareto.json"))
    assert art.n_trees == 4 and art.payload["rtl_verified"]
    assert sorted(os.listdir(out / "ckpt")) == ["ckpt_00000002",
                                                "ckpt_00000004"]
    text = run("--gens", "6", "--resume")
    assert "(32 chromosome evaluations, 1 device dispatches)" in text
    assert "ckpt_00000006" in os.listdir(out / "ckpt")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.search", "serve", "--pareto",
         str(out / "pareto.json"), "--verify-netlist", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "4 tree(s)" in proc.stdout
    assert "equal the gate-level simulation" in proc.stdout


def test_forest_predict_with_a_one_leaf_tree():
    """A forest may hold a one-leaf tree (a bootstrap sample of one class):
    its `ParallelTree` keeps one dummy path column. The port's oracle reads
    only the tree's own comparators, so it votes the leaf's class and
    equals the block-diagonal dataflow; JAX's `forest_predict` raises there
    (a (B, 0) @ (0 + 1) product; ROADMAP Queue 3)."""
    rng = np.random.default_rng(0)
    leaf = t_tree.random_tree(rng, 0, 6, 3)
    trees = [leaf, t_tree.random_tree(rng, 9, 6, 3),
             t_tree.random_tree(rng, 5, 6, 3)]
    forest = t_forest.Forest(trees, [t_tree.to_parallel(t) for t in trees], 3)
    x = rng.random((40, 6)).astype(np.float32)
    y = rng.integers(0, 3, 40)
    tp = t_search.build_forest_problem(forest, x, y, device="cpu")
    assert tp.tree_comparators == (0, 9, 5)
    for g in _random_pop(tp, 6, 2):
        g[2:-1:3] = 0.0
        g[-1] = 0.0
        bits, margin, _, _ = t_quant.decode_tree_genes(torch.as_tensor(g))
        b, t, cap = t_search.decode_chromosome(tp, torch.as_tensor(g))
        np.testing.assert_array_equal(
            t_forest.forest_predict(forest, tp.x8, bits, margin).numpy(),
            t_search.predict_votes(tp, b, t, cap).numpy())
