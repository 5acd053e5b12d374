"""The port's `ClassifyServer` against the JAX package's, on the CPU.

The JAX package writes `pareto.json` with its reference backend (its
`--verify-rtl` needs the Pallas kernel leg, which does not run here); the
port serves every point of it and must equal the JAX server
(`backend="reference"`), the JAX package's netlist and the port's. Tolerance: exact
equality for predictions, 1e-6 for the served accuracy against the
recorded one.
"""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro import search as j_search
from repro.core import faults as j_faults
from repro.core import netlist as j_netlist
from repro.core import train as j_train
from repro.core import tree as j_tree
from repro.runtime.classify import ClassifyServer as JaxServer
from repro_torch.core import netlist as t_netlist
from repro_torch.datasets import load_dataset
from repro_torch.runtime.classify import BACKENDS, ClassifyServer
from repro_torch.search import artifact as t_artifact

REPO = pathlib.Path(__file__).resolve().parents[1]
DATASETS = ("seeds", "vertebral")


@pytest.fixture(scope="module")
def searched(tmp_path_factory):
    """dataset -> (pareto.json path written by JAX, dataset)."""
    root = tmp_path_factory.mktemp("torch_serve")
    out = {}
    for name in DATASETS:
        ds = load_dataset(name)
        problem = j_search.build_tree_problem(
            j_tree.to_parallel(j_train.train_tree(ds.x_train, ds.y_train,
                                                  ds.n_classes)),
            ds.x_test, ds.y_test)
        out_dir = str(root / name)
        j_search.run_search(problem, j_search.SearchConfig(
            pop_size=8, n_generations=2, seed=0, dataset=name,
            out_dir=out_dir))
        out[name] = (out_dir + "/pareto.json", ds)
    return out


def _jax_netlist(artifact, i, codes):
    """The JAX package's netlist of point ``i``, simulated by its per-gate
    numpy oracle (its jnp simulator compiles per circuit, seconds each)."""
    bits, t_int, trunc, vote_adder = artifact.point_design(i)
    circuit = j_netlist.build_circuit(artifact.ptrees(), bits, t_int,
                                      artifact.n_classes, trunc=trunc,
                                      vote_adder=vote_adder)
    return j_faults.simulate_faulty_serial(circuit, np.asarray(codes))


@pytest.mark.parametrize("name", DATASETS)
def test_every_point_equals_jax_server_and_netlist(searched, name):
    path, ds = searched[name]
    j_art = j_search.load_pareto_artifact(path)
    t_art = t_artifact.load_pareto_artifact(path)
    x = np.asarray(ds.x_test)
    assert len(t_art.points) == len(j_art.points) >= 1
    for i in range(len(t_art.points)):
        j_served = JaxServer.from_artifact(j_art, point=i,
                                           backend="reference").classify(x)
        codes = JaxServer.from_artifact(j_art, point=i,
                                        backend="reference").featurize(x)
        np.testing.assert_array_equal(j_served, _jax_netlist(j_art, i, codes))
        bits, t_int, trunc, vote_adder = t_art.point_design(i)
        circuit = t_netlist.build_circuit(t_art.ptrees(), bits, t_int,
                                          t_art.n_classes, trunc=trunc,
                                          vote_adder=vote_adder)
        np.testing.assert_array_equal(
            j_served, t_netlist.simulate(circuit, codes).numpy())
        for backend in BACKENDS:
            server = ClassifyServer.from_artifact(t_art, point=i,
                                                  backend=backend,
                                                  device="cpu")
            np.testing.assert_array_equal(server.featurize(x), codes)
            served = server.classify(x)
            np.testing.assert_array_equal(served, j_served, err_msg=backend)
            # re-serving the point reproduces the accuracy the search recorded
            acc = float((served == ds.y_test).mean())
            assert abs(acc - t_art.point_accuracy(i)) <= 1e-6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_out_of_grid_codes_wrap_like_the_netlist(searched, seed):
    """Integer codes are masked (``& 0xFF``), not clipped: negative and
    >255 codes wrap mod 256 exactly as the circuit's bits 0..7 read them."""
    path, ds = searched["seeds"]
    j_art = j_search.load_pareto_artifact(path)
    idx = j_art.best_under_loss(1.0)
    server = ClassifyServer.from_artifact(path, point=idx, max_batch=64,
                                          device="cpu")
    rng = np.random.default_rng(seed)
    codes = rng.integers(-300, 900, (41, ds.x_test.shape[1])).astype(np.int32)
    np.testing.assert_array_equal(server.sanitize(codes), codes & 0xFF)
    served = server.classify(codes)
    np.testing.assert_array_equal(served, _jax_netlist(j_art, idx, codes))
    np.testing.assert_array_equal(
        served, JaxServer.from_artifact(j_art, point=idx, max_batch=64,
                                        backend="reference").classify(codes))


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("everywhere", [False, True])
def test_non_finite_features_are_rejected(searched, bad, everywhere):
    path, ds = searched["seeds"]
    server = ClassifyServer.from_artifact(path, point=0, device="cpu")
    x = np.asarray(ds.x_test[:5], np.float64).copy()
    if everywhere:
        x[:] = bad
    else:
        x[3, 2] = bad
    steps = server.stats.n_steps
    with pytest.raises(ValueError, match="non-finite"):
        server.classify(x)
    assert server.stats.n_steps == steps
    assert server.classify(np.asarray(ds.x_test[:5])).shape == (5,)


def test_buckets_chunking_and_two_slots(searched):
    path, ds = searched["seeds"]
    server = ClassifyServer.from_artifact(path, point=0, max_batch=16,
                                          device="cpu")
    codes = server.featurize(np.asarray(ds.x_test))
    ref = ClassifyServer.from_artifact(path, point=0, device="cpu",
                                       backend="reference")
    assert [server.bucket_for(n) for n in (1, 8, 9, 16, 17, 1000)] == [
        8, 8, 16, 16, 16, 16]
    np.testing.assert_array_equal(server.classify(codes[:1]),
                                  ref.classify(codes[:1]))
    # 40 rows through max_batch=16: chunks of 16, 16 and 8, in order
    np.testing.assert_array_equal(server.classify(codes[:40]),
                                  ref.classify(codes[:40]))
    assert server.compiled_buckets() == [8, 16]
    assert server.stats.steps_per_bucket == {8: 2, 16: 2}
    # the two buffers of a bucket alternate and keep their storage
    slots = server._slots[16]
    ptrs = [s.x.data_ptr() for s in slots]
    for _ in range(3):
        server.classify(codes[:16])
    assert [s.count for s in slots] == [3, 2]
    assert [s.x.data_ptr() for s in slots] == ptrs
    # an empty request is legal and runs no step
    steps = server.stats.n_steps
    assert server.classify(codes[:0]).shape == (0,)
    assert server.stats.n_steps == steps
    # padding rows are inert: junk rows after the real ones change nothing
    junk = np.vstack([codes[:6], np.full((2, codes.shape[1]), 255, np.int32)])
    np.testing.assert_array_equal(server.classify(junk)[:6],
                                  server.classify(codes[:6]))


def test_serve_cli_verifies_against_netlist(searched):
    path, _ = searched["vertebral"]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.search", "serve", "--pareto", path,
         "--device", "cpu", "--verify-netlist", "--batch", "37"],
        capture_output=True, text=True, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")}, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "served predictions equal the gate-level simulation" in proc.stdout
    missing = subprocess.run(
        [sys.executable, "-m", "repro_torch.search", "serve", "--pareto",
         path + ".missing", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")}, timeout=120)
    assert missing.returncode == 2
    assert len(missing.stderr.strip().splitlines()) == 1
