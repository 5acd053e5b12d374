"""The forest's plain reference (`perfbench/reference/forest.py`) against
the port on the CPU at small sizes: the vote stage's gates, the bagged
trees node for node, the objectives value for value; a small forest cell
run through the harness on a copy of the layout; and the forest's
per-layer readers on a hand-made record."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from perfbench import harness, peaks, spans
from perfbench.reference import cart, data
from perfbench.reference import forest as ref
from perfbench.tests import layout

SEED = 2 ** 31 + 4321
FORM_KEYS = ("feature", "threshold", "path", "path_len", "n_neg",
             "leaf_class")


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("n_trees", range(2, 9))
def test_vote_units_equal_the_port(n_trees, approx):
    from repro_torch.core.area import vote_adder_units

    for n_classes in range(2, 11):
        assert (ref.vote_units(n_trees, n_classes, approx)
                == vote_adder_units(n_trees, n_classes, approx))


def test_one_tree_has_no_vote_stage():
    assert ref.vote_units(1, 6, False) == ref.vote_units(1, 6, True) == 0
    assert ref.vote_units(5, 6, True) < ref.vote_units(5, 6, False)


def _bagged(name: str, n_trees: int):
    ds = data.load(name)
    return ds, ref.train_forest(ds["x_train"], ds["y_train"],
                                ds["n_classes"], n_trees, 0, 0.7)


@pytest.mark.parametrize("name,n_trees", [("seeds", 3), ("vertebral", 3),
                                          ("seeds", 2)])
def test_bagged_trees_equal_the_port(name, n_trees):
    from repro_torch.core.forest import train_forest

    ds, mine = _bagged(name, n_trees)
    port = train_forest(ds["x_train"], ds["y_train"], ds["n_classes"],
                        n_trees=n_trees, seed=0)
    assert len(mine) == len(port.trees) == n_trees
    for tree, theirs, pt in zip(mine, port.trees, port.ptrees):
        for k in ("feature", "threshold", "left", "right", "leaf_class"):
            assert np.array_equal(tree[k], getattr(theirs, k)), k
        form = cart.comparator_form(tree)
        for k in FORM_KEYS:
            assert np.array_equal(form[k], getattr(pt, k)), k


@pytest.fixture(scope="module")
def seeds_forest():
    from repro_torch.core.tree import ParallelTree
    from repro_torch.search.problem import build_problem

    ds, trees = _bagged("seeds", 3)
    ptrees = [ParallelTree(**{k: f[k] for k in FORM_KEYS}, n_classes=3)
              for f in map(cart.comparator_form, trees)]
    problem = build_problem(ptrees, ds["x_test"], ds["y_test"], n_classes=3,
                            device="cpu")
    mine = ref.ForestObjectives(trees, data.quantize_u8(ds["x_test"]),
                                ds["y_test"], 3, "cpu")
    return problem, mine


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forest_objectives_equal_the_port(seeds_forest, seed):
    """Random genes with the vote gene in both halves, coarse precisions
    (so votes tie and the approximate adder's cap decides), and the exact
    design with either adder."""
    from repro_torch.search.problem import objectives

    problem, mine = seeds_forest
    gen = torch.Generator().manual_seed(seed)
    genes = torch.rand((64, problem.n_genes), generator=gen)
    genes[:32, -1] = genes[:32, -1] / 2                 # exact adder
    genes[32:, -1] = 0.5 + genes[32:, -1] / 2           # approximate adder
    genes[16:48, 0:-1:3] *= 0.3                         # 2-3 bits
    exact = torch.as_tensor(problem.exact_genes())
    genes[0], genes[-1] = exact, exact
    genes[-1, -1] = 0.75
    got = mine(genes)
    assert torch.equal(got, objectives(problem, genes))
    assert got[0].tolist() == [0.0, 1.0]
    assert got[-1, 1] < 1.0                 # the approximate adder is smaller
    assert mine.n == problem.n_comparators
    assert mine.exact_units == problem.exact_units


def test_forest_cell_runs_in_a_copy_of_the_layout(tmp_path):
    """The forest family, a three-tree seeds configuration and its cell,
    added to a copy of the layout as files and entries: run correct by
    the harness on the CPU, reporting the forest's end-to-end metric."""
    root = layout.make(tmp_path)
    cfg = json.loads((root / "perfbench/configs/forest-har.json").read_text())
    cfg.update(name="forest-seeds", dataset="seeds", n_trees=3)
    layout.write_json(root / "perfbench/configs/forest-seeds.json", cfg)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = "forest-seeds.search-tiny"
    bench["configs"].append({"name": "forest-seeds", "source": "x",
                             "file": "perfbench/configs/forest-seeds.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": cell, "config": "forest-seeds",
                               "traffic": "search-tiny", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "forest-har.search-p512" in m.get("workloads", ()):
            m["workloads"].append(cell)
    layout.write_json(root / "BENCHMARK.json", bench)
    result = harness.run_cell(cell, SEED, 0.2, False, device="cpu", root=root)
    assert result["correct"], result["check"]
    assert set(result["metrics"]) == {"evals_per_s", "setup_s"}
    assert all(c["value"] == 0 for c in result["check"].values())
    assert result["attempted"] > 0 and result["failed"] == 0


FOREST_SHAPE = {"family": "bagged_forest", "pop": 512, "rows": 3090,
                "comparators": 2227, "features_used": 441,
                "path_compares": 173.9, "gen_ops": 512 * 3090 * 173.9,
                "gen_peak": peaks.FP32_OPS_PER_S}
FOREST = {"kind": "search", "traced_generations": 120, "shape": FOREST_SHAPE,
          "trace": {"busy_s": 0.5, "window_s": 0.52,
                    "kernels": {"anon::fitness_mma_kernel": [0.45, 100]}}}
FOREST_SEEN = {"spans": [],
               "counts": {"nsga2.evaluations": 120 * 512,
                          "fitness.path_macs": 120 * 512 * 3090 * 662_528}}
BOUND_S = max(512 * 3090 * 173.9 / peaks.FP32_OPS_PER_S,
              (3090 * 441 + 512 * (3 * 2227 + 1) * 4 + 512 * 4)
              / peaks.HBM_BYTES_PER_S)
READERS = {
    "fitness_path_macs_per_row.forest": 662_528,
    "fitness_roofline.forest": 100 * BOUND_S / 0.0045,
    "idle_share.forest": 1 - 0.5 / 0.52,
    "gen_mfu.forest": 100 * 512 * 3090 * 173.9 / (
        0.52 / 120 * peaks.FP32_OPS_PER_S),
}


def _reader(name):
    return harness.load_module(layout.REPO / "perfbench/metrics"
                               / f"{name}.py")


@pytest.mark.parametrize("name", sorted(READERS))
def test_forest_reader_reads_the_record(monkeypatch, name):
    monkeypatch.setattr(spans, "recorded", lambda: FOREST_SEEN)
    assert _reader(name).read(FOREST) == pytest.approx(READERS[name])


@pytest.mark.parametrize("name", sorted(READERS))
def test_forest_reader_is_none_untraced(monkeypatch, name):
    """An untraced run gives each nothing; a program that keeps no path
    counter (the commit before it) gives the counter's reader nothing."""
    monkeypatch.setattr(spans, "recorded", lambda: FOREST_SEEN)
    assert _reader(name).read(dict(FOREST, trace=None)) is None
    older = {"spans": [], "counts": {"nsga2.evaluations": 120 * 512}}
    monkeypatch.setattr(spans, "recorded", lambda: older)
    if name == "fitness_path_macs_per_row.forest":
        assert _reader(name).read(FOREST) is None
