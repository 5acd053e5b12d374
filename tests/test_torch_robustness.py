"""Parity of the port's robustness campaign (`repro_torch.search.
robustness`, the `faults` CLI, `sweep --fault-report`) with the JAX
package's, on the CPU.

Artifacts: a `seeds` tree and a `seeds` printed MLP (hidden 4), each
searched by the JAX package (pop 8, 2 generations) into a pareto.json that
both packages load, and campaigns over the first 32 test vectors.

Tolerance: exact equality everywhere, float64 accuracies included, except
`monte_carlo` under the port's own draws: torch cannot replay JAX's
`fold_in` keys, so those draws are held to their own rules (reproducible
under a seed, moved by another, prefix-stable in `n_trials`), and the
Monte-Carlo metric, fed JAX's draws, equals JAX's dict exactly.
"""
from __future__ import annotations

import copy
import json

import jax
import numpy as np
import pytest

from repro import search as j_search
from repro.core import faults as j_faults
from repro.core.train import train_tree
from repro.core.tree import to_parallel
from repro.datasets import load_dataset, quantize_u8
from repro.families import printed_mlp as j_pm
from repro.search import robustness as j_rob
from repro.search import sweep as j_sweep
from repro_torch import search as t_search
from repro_torch.core import faults as t_faults
from repro_torch.search import robustness as t_rob
from repro_torch.search import sweep as t_sweep
from repro_torch.search.__main__ import faults_main, sweep_main

N_VECTORS = 32
MC_TRIALS = 4


def _jax_artifact(root, family: str) -> str:
    """A pareto.json written by a tiny JAX search of seeds."""
    ds = load_dataset("seeds")
    if family == "mlp":
        problem = j_pm.build_problem("seeds", n_hidden=4)
    else:
        pt = to_parallel(train_tree(ds.x_train, ds.y_train, ds.n_classes))
        problem = j_search.build_tree_problem(pt, ds.x_test, ds.y_test)
    out = str(root / family)
    j_search.run_search(problem, j_search.SearchConfig(
        pop_size=8, n_generations=2, seed=0, dataset="seeds", out_dir=out))
    return out + "/pareto.json"


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("robustness")
    return {f: _jax_artifact(root, f) for f in ("tree", "mlp")}


@pytest.fixture(scope="module")
def split():
    ds = load_dataset("seeds")
    return (quantize_u8(ds.x_test)[:N_VECTORS],
            np.asarray(ds.y_test[:N_VECTORS], np.int64))


@pytest.fixture(scope="module")
def reports(artifacts, split):
    """family -> (JAX report, port report) over the same artifact."""
    x8, y = split
    out = {}
    for family, path in artifacts.items():
        point = "all" if family == "tree" else "best"
        kw = dict(source="pareto.json", point=point, n_trials=MC_TRIALS)
        out[family] = (
            j_rob.run_campaign(j_search.load_pareto_artifact(path), x8, y,
                               **kw),
            t_rob.run_campaign(t_search.load_pareto_artifact(path), x8, y,
                               device="cpu", **kw))
    return out


def _jax_draws(n_sites: int, n_trials: int, defect_rate: float, seed: int):
    """The (T, S) hit and polarity masks of `repro.search.robustness.
    monte_carlo`, drawn the way it draws them."""
    base = jax.random.key(seed)
    hit = np.zeros((n_trials, n_sites), bool)
    pol = np.zeros((n_trials, n_sites), bool)
    for t in range(n_trials):
        k_hit, k_pol = jax.random.split(jax.random.fold_in(base, t))
        hit[t] = np.asarray(jax.random.bernoulli(k_hit, defect_rate,
                                                 (n_sites,)))
        pol[t] = np.asarray(jax.random.bernoulli(k_pol, 0.5, (n_sites,)))
    return hit, pol


def _without_mc(report: dict) -> dict:
    report = copy.deepcopy(report)
    for p in report["points"]:
        p.pop("monte_carlo")
    return report


# --- the campaign against the JAX package -------------------------------------

@pytest.mark.parametrize("family", ["tree", "mlp"])
def test_report_equals_jax_but_monte_carlo(reports, family):
    want, got = reports[family]
    assert got["family"] == family and len(got["points"]) >= 1
    assert _without_mc(got) == _without_mc(want)
    assert json.dumps(_without_mc(got)) == json.dumps(_without_mc(want))
    for p in got["points"]:
        assert p["zero_fault_matches_simulate"] is True
        assert set(p["monte_carlo"]) == t_rob.REQUIRED_MC_KEYS


@pytest.mark.parametrize("family", ["tree", "mlp"])
def test_reports_pass_each_others_validator(reports, family, tmp_path):
    for report in reports[family]:
        for rob in (j_rob, t_rob):
            assert rob.validate_fault_report(report) is report
        path = str(tmp_path / "fault_report.json")
        t_rob.write_fault_report(report, path)
        assert j_rob.load_fault_report(path) == t_rob.load_fault_report(
            path) == json.loads(json.dumps(report))


@pytest.mark.parametrize("family", ["tree", "mlp"])
@pytest.mark.parametrize("rate,seed", [(0.02, 0), (0.2, 5)])
def test_monte_carlo_on_jax_draws_equals_jax(artifacts, split, family, rate,
                                             seed):
    """Given JAX's masks, the port's Monte-Carlo metric is JAX's dict,
    per-trial accuracies included."""
    x8, y = split
    path = artifacts[family]
    j_art = j_search.load_pareto_artifact(path)
    t_art = t_search.load_pareto_artifact(path)
    idx = j_art.best_under_loss(0.01)
    from repro.families import get_family as j_family
    from repro_torch.families import get_family as t_family
    jc = j_family(family).build_point_circuit(j_art, idx)
    tc = t_family(family).build_point_circuit(t_art, idx)
    want = j_rob.monte_carlo(j_faults.FaultSimulator(jc), x8, y,
                             defect_rate=rate, n_trials=8, seed=seed)
    hit, pol = _jax_draws(len(t_faults.enumerate_fault_sites(tc)), 8, rate,
                          seed)
    got = t_rob.monte_carlo_metrics(t_faults.FaultSimulator(tc, "cpu"),
                                    x8, y, hit, pol)
    np.testing.assert_array_equal(got.pop("_accuracies"),
                                  want.pop("_accuracies"))
    assert got == want


# --- the port's own draws -----------------------------------------------------

def test_draws_reproduce_under_a_seed_and_move_under_another():
    a = t_rob.draw_defects(500, n_trials=8, seed=11)
    b = t_rob.draw_defects(500, n_trials=8, seed=11)
    c = t_rob.draw_defects(500, n_trials=8, seed=12)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    assert not np.array_equal(a[1], c[1])
    assert a[0].shape == a[1].shape == (8, 500)
    assert a[0].dtype == a[1].dtype == bool


def test_draws_are_prefix_stable_in_n_trials():
    """Trial t's masks do not depend on how many trials are drawn."""
    short = t_rob.draw_defects(300, n_trials=3, seed=4)
    long = t_rob.draw_defects(300, n_trials=10, seed=4)
    for s, l in zip(short, long):
        np.testing.assert_array_equal(l[:3], s)
    assert not np.array_equal(long[0][0], long[0][1])   # trials differ


def test_draw_rates():
    """Hits at the defect rate, polarity a fair coin (deterministic under
    the seed: 64 trials x 2000 sites)."""
    hit, pol = t_rob.draw_defects(2000, defect_rate=0.05, n_trials=64,
                                  seed=0)
    assert abs(hit.mean() - 0.05) < 0.005
    assert abs(pol.mean() - 0.5) < 0.01
    none, _ = t_rob.draw_defects(50, defect_rate=0.0, n_trials=4, seed=0)
    assert not none.any()


def test_monte_carlo_reproducible_under_fixed_seed(artifacts, split):
    x8, y = split
    art = t_search.load_pareto_artifact(artifacts["tree"])
    from repro_torch.families import get_family
    circuit = get_family("tree").build_point_circuit(art, 0)
    sim = t_faults.FaultSimulator(circuit, device="cpu")
    a = t_rob.monte_carlo(sim, x8, y, n_trials=8, seed=11)
    b = t_rob.monte_carlo(sim, x8, y, n_trials=8, seed=11)
    np.testing.assert_array_equal(a.pop("_accuracies"), b.pop("_accuracies"))
    assert a == b
    c = t_rob.monte_carlo(sim, x8, y, n_trials=8, seed=12, defect_rate=0.3)
    assert c.pop("_accuracies").shape == (8,)
    assert c["mean_faulty_sites"] != a["mean_faulty_sites"]


def test_defaults_equal_jax():
    for name in ("DEFAULT_DEFECT_RATE", "DEFAULT_TRIALS", "DEFAULT_TOP_K",
                 "DEFAULT_MC_SEED", "REQUIRED_TOP_KEYS", "OPTIONAL_TOP_KEYS",
                 "REQUIRED_POINT_KEYS", "REQUIRED_SINGLE_FAULT_KEYS",
                 "REQUIRED_MC_KEYS", "REQUIRED_CRITICAL_KEYS"):
        assert getattr(t_rob, name) == getattr(j_rob, name), name
    assert (t_rob.DEFAULT_DEFECT_RATE, t_rob.DEFAULT_TRIALS,
            t_rob.DEFAULT_TOP_K, t_rob.DEFAULT_MC_SEED) == (0.02, 32, 10, 0)


def test_critical_gates_equal_jax():
    """Ranking on (-drop, gate) with float64 drops, ties included."""
    rng = np.random.default_rng(0)
    sites = [t_faults.FaultSite(g, "gate", "and", f"and@{g}")
             for g in rng.permutation(40) + 2]
    accs = rng.choice([0.25, 0.5, 0.75, 0.8125], size=2 * len(sites))
    for k in (1, 10, 100):
        assert t_rob.critical_gates(sites, accs, 0.8125, top_k=k) == \
            j_rob.critical_gates(sites, accs, 0.8125, top_k=k)


# --- fault_report.json schema ---------------------------------------------------

SCHEMA_BREAKS = {
    "top_missing": (lambda r: r.pop("defect_rate"),
                    r"missing keys.*defect_rate"),
    "top_unknown": (lambda r: r.update(surprise=1), r"unknown keys.*surprise"),
    "not_object": (None, "expected a JSON object"),
    "points_not_list": (lambda r: r.update(points={}), "must be a list"),
    "point_not_object": (lambda r: r["points"].append(3),
                         r"points\[\d+\]: must be an object"),
    "point_missing": (lambda r: r["points"][0].pop("n_gates"),
                      r"points\[0\]: missing keys.*n_gates"),
    "single_fault": (lambda r: r["points"][0]["single_fault"].pop(
        "worst_drop"), r"single_fault.*missing keys.*worst_drop"),
    "monte_carlo": (lambda r: r["points"][0]["monte_carlo"].update(extra=0),
                    r"monte_carlo.*unknown keys"),
    "critical_gates": (lambda r: r["points"][0]["critical_gates"][0].pop(
        "drop"), r"critical_gates\[0\].*missing keys"),
    "n_faults": (lambda r: r["points"][0].update(
        n_faults=r["points"][0]["n_faults"] + 1), r"not 2 \* n_sites"),
    "zero_fault": (lambda r: r["points"][0].update(
        zero_fault_matches_simulate=False), "diverged"),
}


@pytest.mark.parametrize("name", sorted(SCHEMA_BREAKS))
def test_schema_rejections_equal_jax(reports, name):
    """Each break raises a named `ValueError`, the same in both packages."""
    breaker, pattern = SCHEMA_BREAKS[name]
    bad = copy.deepcopy(reports["tree"][1])
    if breaker is None:
        bad = [bad]
    else:
        breaker(bad)
    msgs = []
    for rob in (t_rob, j_rob):
        with pytest.raises(ValueError, match=pattern) as exc:
            rob.validate_fault_report(bad)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_select_points():
    class FakeArtifact:
        points = [{"acc_loss": 0.0, "norm_area": 0.9},
                  {"acc_loss": 0.005, "norm_area": 0.5},
                  {"acc_loss": 0.2, "norm_area": 0.1}]

        def best_under_loss(self, max_loss=0.01):
            ok = [i for i, p in enumerate(self.points)
                  if p["acc_loss"] <= max_loss]
            return min(ok, key=lambda i: self.points[i]["norm_area"]) \
                if ok else None

    art = FakeArtifact()
    for spec, want in (("all", [0, 1, 2]), ("best", [1]), ("2", [2]),
                       ("-1", [2])):
        assert t_rob.select_points(art, spec) == want == \
            j_rob.select_points(art, spec)
    with pytest.raises(ValueError, match="out of range"):
        t_rob.select_points(art, "7")
    art.points = [{"acc_loss": 0.5, "norm_area": 0.5}]
    with pytest.raises(ValueError, match="no pareto point"):
        t_rob.select_points(art, "best")


# --- the faults CLI -------------------------------------------------------------

def test_faults_cli_end_to_end(artifacts, tmp_path, capsys):
    """`faults --device cpu` writes a report both validators accept, equal
    to the JAX CLI's but for monte_carlo and source."""
    got_path = str(tmp_path / "port.json")
    want_path = str(tmp_path / "jax.json")
    argv = ["--pareto", artifacts["tree"], "--point", "best", "--trials", "4"]
    faults_main(argv + ["--out", got_path, "--device", "cpu"])
    assert "report:" in capsys.readouterr().out
    from repro.search.__main__ import faults_main as j_faults_main
    j_faults_main(argv + ["--out", want_path])
    got = j_rob.load_fault_report(got_path)
    want = t_rob.load_fault_report(want_path)
    assert got["dataset"] == "seeds" and len(got["points"]) == 1
    assert _without_mc(got) == _without_mc(want)


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.mark.parametrize("case", ["missing", "truncated", "schema",
                                  "bad_point"])
def test_faults_cli_exits_2_with_one_line(artifacts, tmp_path, capsys, case):
    """A missing, truncated or schema-violating artifact, or a campaign
    `ValueError`: exit 2 and one named line on stderr, no traceback."""
    path, want = {
        "missing": (str(tmp_path / "nope" / "pareto.json"),
                    "FileNotFoundError"),
        "truncated": (_write(tmp_path / "truncated.json",
                             '{"backend": "reference", "pareto": [{"acc_l'),
                      "JSONDecodeError"),
        "schema": (_write(tmp_path / "schema.json",
                          json.dumps({"backend": "reference"})),
                   "missing keys"),
        "bad_point": (artifacts["tree"], "out of range"),
    }[case]
    argv = ["--pareto", str(path), "--device", "cpu"]
    if case == "bad_point":
        argv += ["--point", "99"]
    with pytest.raises(SystemExit) as exc:
        faults_main(argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and want in err[0] and err[0].startswith("error: ")


def test_faults_cli_device_is_explicit(artifacts, capsys):
    """Without --device the campaign wants cuda: exit 2 naming it where
    there is none."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(SystemExit) as exc:
        faults_main(["--pareto", artifacts["tree"]])
    assert exc.value.code == 2
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err


# --- sweep --fault-report ---------------------------------------------------------

@pytest.fixture(scope="module")
def fault_sweep(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sweep") / "sw")
    sweep_main(["--datasets", "seeds,vertebral", "--pop", "16", "--gens",
                "4", "--out", out, "--report", "--fault-report",
                "--fault-chunk", "3", "--device", "cpu"])
    return out


@pytest.mark.parametrize("name", ["seeds", "vertebral"])
def test_sweep_fault_report_rows_equal_jax(fault_sweep, name):
    """Each dataset's fault_report.json passes both validators, and its
    robustness row equals the JAX `_robustness_summary` of the same file."""
    path = f"{fault_sweep}/{name}/fault_report.json"
    report = t_rob.load_fault_report(path)
    assert j_rob.load_fault_report(path) == report
    assert report["dataset"] == name and len(report["points"]) == 1
    assert report["points"][0]["zero_fault_matches_simulate"] is True
    row = t_sweep._robustness_summary(path)
    assert row is not None and row == j_sweep._robustness_summary(path)
    with open(f"{fault_sweep}/sweep_report.json") as f:
        assert json.load(f)["datasets"][name]["robustness"] == row


def test_sweep_report_markdown_equals_jax(fault_sweep):
    with open(f"{fault_sweep}/sweep_report.json") as f:
        payload = json.load(f)
    got = t_sweep._report_markdown(payload, 0.01)
    assert got == j_sweep._report_markdown(payload, 0.01)
    assert "## Robustness vs area" in got
    with open(f"{fault_sweep}/REPORT.md") as f:
        assert f.read() == got


def test_robustness_summary_is_loose(tmp_path):
    """No report, or an invalid one, gives no row in either package."""
    missing = str(tmp_path / "fault_report.json")
    assert t_sweep._robustness_summary(missing) is None
    bad = _write(tmp_path / "bad.json", json.dumps({"points": []}))
    assert t_sweep._robustness_summary(bad) is None
    assert j_sweep._robustness_summary(bad) is None
