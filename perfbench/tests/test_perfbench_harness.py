"""The harness on the CPU: BENCHMARK.json against the benchmark's
contract, the small cells run end to end, files dropped into a copy of the
layout found by name, and the refusal to run without a card."""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from perfbench import harness, tracing
from perfbench.tests import layout

REPO = layout.REPO
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return layout.make(tmp_path_factory.mktemp("perfbench"))


def test_top_level_keys_and_paths():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 << 10


def test_names_units_and_entry_keys():
    names = [e["name"] for e in BENCH["configs"] + BENCH["workloads"] + METRICS]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).is_file()
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_is_complete(cell):
    """Each cell: its files exist, it reports setup_s, one other end-to-end
    metric and a per-layer metric, each per-layer metric moves an
    end-to-end metric the cell reports."""
    spec = harness.entry(BENCH["workloads"], cell, "cell")
    assert spec["chips"] == 1 and len(spec["why"]) <= 200
    traffic = json.loads(
        (REPO / "perfbench/traffic" / f"{spec['traffic']}.json").read_text())
    assert (REPO / "perfbench/kinds" / f"{traffic['kind']}.py").is_file()

    def listed(m):
        return "workloads" not in m or cell in m["workloads"]

    e2e = {m["name"] for m in BENCH["end_to_end"] if listed(m)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in BENCH["per_layer"] if listed(m)]
    assert layer and all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    path = REPO / "perfbench/metrics" / f"{metric}.py"
    assert callable(harness.load_module(path).read)


@pytest.mark.parametrize("cell", sorted(layout.CELLS))
def test_small_cell_runs_and_is_correct(root, cell):
    result = harness.run_cell(cell, SEED, 0.3, False, device="cpu", root=root)
    assert result["correct"], result["check"]
    assert list(result)[-1] == "check"
    assert result["attempted"] > 0 and result["failed"] == 0
    e2e = {"tree-seeds.search-tiny": "evals_per_s",
           "mlp-seeds.search-tiny": "evals_per_s.mlp",
           "tree-seeds.faults": "fault_lanes_per_s"}[cell]
    assert set(result["metrics"]) == {e2e, "setup_s"}
    assert all(c["value"] == 0 for c in result["check"].values())


def test_same_seed_same_inputs(root):
    """The seed fixes the work: two runs of a seed check the same numbers."""
    a = harness.run_cell("tree-seeds.faults", 7, 0.1, False, device="cpu",
                         root=root)
    b = harness.run_cell("tree-seeds.faults", 7, 0.1, False, device="cpu",
                         root=root)
    assert a["check"] == b["check"]


def test_files_dropped_into_a_copy_are_found(root, tmp_path):
    """A configuration, a mix, a cell and a metric added as files and
    entries, no file edited."""
    new = layout.make(tmp_path)
    cfg = json.loads((new / "perfbench/configs/tree-seeds.json").read_text())
    cfg.update(name="tree-vertebral", dataset="vertebral")
    layout.write_json(new / "perfbench/configs/tree-vertebral.json", cfg)
    mix = json.loads((new / "perfbench/traffic/search-tiny.json").read_text())
    mix.update(pop_size=6, chunk_generations=3)
    layout.write_json(new / "perfbench/traffic/search-six.json", mix)
    (new / "perfbench/metrics/evals_done.py").write_text(
        "def read(record):\n"
        "    return record.get('evals')\n")
    bench = json.loads((new / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tree-vertebral", "source": "x",
                             "file": "perfbench/configs/tree-vertebral.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tree-vertebral.search-six",
                               "config": "tree-vertebral",
                               "traffic": "search-six", "chips": 1,
                               "why": "x"})
    bench["end_to_end"].append({"name": "evals_done", "unit": "evals",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["tree-vertebral.search-six"]})
    layout.write_json(new / "BENCHMARK.json", bench)
    result = harness.run_cell("tree-vertebral.search-six", 3, 0.2, False,
                              device="cpu", root=new)
    assert result["correct"]
    assert result["metrics"]["evals_done"]["value"] % (6 * 3) == 0
    assert "evals_done" not in harness.run_cell(
        "tree-seeds.search-tiny", 3, 0.1, False, device="cpu",
        root=new)["metrics"]


FOREST_FAMILY = '''"""Family "forest" of the test: bagged CART trees voting, the port's
joint problem over them. It scores with the port's plain objectives, a
stand-in for this test of the harness alone; a forest cell brings a plain
reference of its own."""
import numpy as np

from perfbench import peaks
from perfbench.reference import cart, data

KEYS = ("feature", "threshold", "path", "path_len", "n_neg", "leaf_class")


def make_inputs(config):
    ds = data.load(config["dataset"], config["test_fraction"],
                   config["split_seed"])
    rng = np.random.default_rng(config["bag_seed"])
    n = ds["x_train"].shape[0]
    out = {"x_test": ds["x_test"], "y_test": ds["y_test"],
           "n_classes": np.int64(ds["n_classes"])}
    for k in range(config["n_trees"]):
        rows = rng.integers(0, n, n)
        tree = cart.train_tree(ds["x_train"][rows], ds["y_train"][rows],
                               ds["n_classes"])
        out.update({f"tree{k}_{key}": v for key, v in tree.items()})
    return out


def _trees(ctx):
    from repro_torch.core.tree import ParallelTree

    for k in range(ctx.config["n_trees"]):
        tree = {key[len(f"tree{k}_"):]: v for key, v in ctx.inputs.items()
                if key.startswith(f"tree{k}_")}
        form = cart.comparator_form(tree)
        yield ParallelTree(**{key: form[key] for key in KEYS},
                           n_classes=int(ctx.inputs["n_classes"]))


def problem(ctx):
    from repro_torch.search import problem as problem_mod

    made = problem_mod.build_problem(
        list(_trees(ctx)), ctx.inputs["x_test"], ctx.inputs["y_test"],
        n_classes=int(ctx.inputs["n_classes"]), device=ctx.device)
    shape = {"family": "forest", "pop": int(ctx.traffic["pop_size"]),
             "rows": int(made.y.shape[0]), "trees": int(made.n_trees),
             "gen_ops": 1.0, "gen_peak": peaks.FP32_OPS_PER_S}
    return made, shape


def objectives(ctx):
    from repro_torch.search import problem as problem_mod

    made = problem(ctx)[0]
    return lambda genes: problem_mod.objectives(made, genes)
'''


def test_a_forest_family_dropped_into_a_copy_runs(tmp_path):
    """A family of several trees, its configuration, a cell of it and its
    metrics added as files and entries: the harness, the inputs' cache and
    the search kind run it as they are, and no file of the copy changes
    but BENCHMARK.json, which only gains entries."""
    new = layout.make(tmp_path)
    before = {p: p.read_bytes() for p in new.rglob("*") if p.is_file()}
    (new / "perfbench/families/forest.py").write_text(FOREST_FAMILY)
    cfg = {"name": "forest-seeds", "family": "forest", "dataset": "seeds",
           "test_fraction": 0.3, "split_seed": 0, "n_trees": 2,
           "bag_seed": 0}
    layout.write_json(new / "perfbench/configs/forest-seeds.json", cfg)
    (new / "perfbench/metrics/evals_per_s.forest.py").write_text(
        "from perfbench import readers\n\n\n"
        "def read(record):\n"
        "    return readers.evals_per_s(record)\n")
    (new / "perfbench/metrics/forest_trees.py").write_text(
        "def read(record):\n"
        "    return record['shape']['trees']\n")
    bench = json.loads((new / "BENCHMARK.json").read_text())
    listed = json.dumps(bench)
    cell = "forest-seeds.search-tiny"
    bench["configs"].append({"name": "forest-seeds", "source": "x",
                             "file": "perfbench/configs/forest-seeds.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": cell, "config": "forest-seeds",
                               "traffic": "search-tiny", "chips": 1,
                               "why": "x"})
    for name, unit in (("evals_per_s.forest", "evals/s"),
                       ("forest_trees", "trees")):
        bench["end_to_end"].append({"name": name, "unit": unit,
                                    "better": "higher", "bound": 0.05,
                                    "source": "host_clock",
                                    "workloads": [cell]})
    layout.write_json(new / "BENCHMARK.json", bench)
    result = harness.run_cell(cell, SEED, 0.2, False, device="cpu", root=new)
    assert result["correct"], result["check"]
    assert set(result["metrics"]) == {"evals_per_s.forest", "forest_trees",
                                      "setup_s"}
    assert result["metrics"]["forest_trees"]["value"] == 2
    assert result["metrics"]["evals_per_s.forest"]["value"] > 0
    for path, text in before.items():
        if path.name == "BENCHMARK.json":
            old = json.loads(listed)
            now = json.loads(path.read_text())
            assert all(now[k][:len(old[k])] == old[k] for k in old
                       if isinstance(old[k], list))
        else:
            assert path.read_bytes() == text, path
    cached = list((new / "build/perfbench/inputs").glob("forest-seeds-*"))
    assert len(cached) == 1


def test_trace_reduction():
    """Busy time is the union of device spans inside the window; a gap is
    named by the innermost host span open when it began."""
    device = [(-50, -40, "k0"), (-5, 10, "void k1(int)"), (5, 20, "k2"),
              (30, 40, "k1"), (100, 110, "k1")]
    host = [(-60, -45, "prime"), (0, 105, tracing.WINDOW), (0, 200, "chunk"),
            (21, 60, "aten::rand"), (61, 99, "cudaGraphLaunch")]
    t = tracing.reduce(device, host)
    assert t["window_s"] == pytest.approx(110e-9)
    assert t["busy_s"] == pytest.approx(40e-9)
    assert t["kernels"]["k1"] == [pytest.approx(30e-9), 3]
    assert "k0" not in t["kernels"]
    assert t["idle_gaps"] == [["aten::rand", pytest.approx(60e-9)],
                              ["chunk", pytest.approx(10e-9)]]
    assert tracing.kernel_seconds(t, ("k2",)) == (pytest.approx(15e-9), 1)
    assert tracing.short("void at::native::(anonymous namespace)::k<4>(int*)"
                         ) == "at::native::anon::k<4>"


def test_run_refuses_without_enough_cards(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot show")
    env = {**os.environ, "HOME": str(tmp_path)}
    out = subprocess.run(
        [sys.executable, str(REPO / "perfbench/run.py"), "--workload",
         "tree-har.search-p512", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=REPO, env=env,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
