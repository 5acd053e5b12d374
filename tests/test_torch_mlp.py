"""Parity of the port's printed-MLP family with the JAX package, on the CPU.

Tolerances: exact equality, except
- `train_mlp`, which runs 300 float32 gradient steps in XLA on one side
  and ATen on the other: from the same initial draws the trained weights
  agree within 1e-5 of the layer's largest magnitude (measured: below 2e-6),
  and the master codes are equal wherever ``w / scale`` is not within 1e-4
  of a rounding tie;
- the area objective, which the port scores as
  ``float32(units) / float32(exact_units)`` over integer quanta (as its tree
  family does) while the JAX package rounds ``units * 0.01`` and then
  divides: the two agree within 2^-23 of the value (ROADMAP.md Queue 3);
- the jitted JAX fitness, whose accuracy differs from the un-jitted
  reference (which the port equals) by up to 2^-23 (ROADMAP.md Queue 3).

The JAX `netlist.simulate` compiles per circuit and is slow on the CPU, so
it runs on hidden-4 circuits only; elsewhere `predict_master` and the JAX
package's per-gate numpy simulator are the oracles.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import families as j_families
from repro import search as j_search
from repro.core import area as j_area
from repro.core import faults as j_faults
from repro.core import netlist as j_netlist
from repro.core import rtl as j_rtl
from repro.families import printed_mlp as j_pm
from repro.quantize import bespoke as j_bespoke
from repro.runtime.classify import ClassifyServer as JaxServer
from repro_torch import convert
from repro_torch import families as t_families
from repro_torch import search as t_search
from repro_torch.core import area as t_area
from repro_torch.core import netlist as t_netlist
from repro_torch.core import rtl as t_rtl
from repro_torch.datasets import load_dataset
from repro_torch.device import CudaUnavailableError
from repro_torch.families import printed_mlp as t_pm
from repro_torch.quantize import bespoke as t_bespoke
from repro_torch.runtime.classify import BACKENDS, ClassifyServer
from repro_torch.search import artifact as t_artifact

REPO = pathlib.Path(__file__).resolve().parents[1]
AREA_TOL = 2.0 ** -23


@pytest.fixture(scope="module")
def problems():
    """hidden -> (JAX MLPProblem, the port's problem on its masters), on
    the seeds dataset."""
    out = {}
    for hidden in (4, 16):
        jp = j_pm.build_problem("seeds", n_hidden=hidden)
        out[hidden] = (jp, convert.mlp_problem_from_arrays(
            jp.w1_master, jp.w2_master, jp.shift, jp.n_classes, jp.x8, jp.y,
            device="cpu"))
    return out


def _random_pop(seed, n_pop, n_genes, exact):
    rng = np.random.default_rng(seed)
    pop = rng.uniform(size=(n_pop, n_genes)).astype(np.float32)
    pop[0] = exact
    # decode edges: the bits / margin bucket boundaries and both ends
    pop[1, :] = np.resize(np.float32([0.0, 1.0, 1 / 3, 2 / 3, 1 / 6, 5 / 6]),
                          n_genes)
    return pop


# ---------------------------------------------------------------------------
# snap tables, masters, decode tables, area cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", range(2, 9))
def test_snap_lut_equal(bits):
    for margin in range(6):
        got = t_bespoke.snap_lut(bits, margin)
        np.testing.assert_array_equal(got, j_bespoke.snap_lut(bits, margin))
        assert not got.flags.writeable


@pytest.mark.parametrize("hidden", [4, 16])
def test_masters_shift_and_combo_tables_equal(problems, hidden):
    jp, tp = problems[hidden]
    f = jp.n_features
    assert t_pm.pick_shift(f, hidden) == j_pm.pick_shift(f, hidden) == jp.shift
    for n_feat in (7, 16, 561):
        assert t_pm.pick_shift(n_feat, hidden) == j_pm.pick_shift(n_feat,
                                                                  hidden)
        assert t_pm.acc1_bound(n_feat) == j_pm.acc1_bound(n_feat)
        assert (t_pm._acc_widths(n_feat, hidden, 4)
                == j_pm._acc_widths(n_feat, hidden, 4))
    rng = np.random.default_rng(hidden)
    w = rng.standard_normal((f, hidden)) * 0.3
    np.testing.assert_array_equal(t_pm.quantize_master(w),
                                  j_pm.quantize_master(w))
    bits = rng.integers(2, 5, hidden)
    margin = rng.integers(0, 6, hidden)
    np.testing.assert_array_equal(
        t_pm.effective_weights(jp.w1_master, bits, margin),
        j_pm.effective_weights(jp.w1_master, bits, margin))
    tables = t_pm.combo_tables(jp.w1_master, jp.w2_master, jp.shift)
    for got, want in zip(tables, j_pm.combo_tables(jp.w1_master,
                                                   jp.w2_master, jp.shift)):
        np.testing.assert_array_equal(got, want.astype(got.dtype))
    ops = jp.operands
    np.testing.assert_array_equal(tp.tw1.numpy(), np.asarray(ops.tw1))
    np.testing.assert_array_equal(tp.tw2.numpy(), np.asarray(ops.tw2))
    np.testing.assert_array_equal(tp.cost1.numpy(), np.asarray(ops.cost1))
    np.testing.assert_array_equal(tp.cost2.numpy(), np.asarray(ops.cost2))
    np.testing.assert_array_equal(tp.x8.numpy(), jp.x8)
    assert tp.exact_accuracy == jp.exact_accuracy
    assert abs(tp.exact_area_mm2 - jp.exact_area_mm2) <= 1e-6 * jp.exact_area_mm2
    assert tp.n_genes == jp.n_genes
    np.testing.assert_array_equal(tp.exact_genes(), jp.exact_genes())


def test_mlp_area_cells_equal():
    for name in ("AREA_FA_MM2", "AREA_ACT_BIT_MM2", "_FA_UNITS",
                 "_ACT_BIT_UNITS"):
        assert getattr(t_area, name) == getattr(j_area, name)
    for code in range(-128, 128):
        for in_bits in (1, 8, 13):
            assert (t_area.mac_area_units(code, in_bits)
                    == j_area.mac_area_units(code, in_bits))
    for acc_bits in (1, 14, 24):
        assert t_area.act_area_units(acc_bits) == j_area.act_area_units(
            acc_bits)
    codes = np.random.default_rng(0).integers(-8, 8, 40)
    assert (t_area.mlp_neuron_area_units(codes, 8, 14)
            == j_area.mlp_neuron_area_units(codes, 8, 14))


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_combos_equal(seed):
    pop = _random_pop(seed, 32, 2 * 19, j_pm.exact_genes(19))
    got = t_pm.decode_combos(torch.as_tensor(pop)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(j_pm.decode_combos(jnp.asarray(pop))))
    for g in pop[:4]:
        for a, b in zip(t_pm.decode_design(g), j_pm.decode_design(g)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["seeds", "vertebral", "balance"])
def test_train_mlp_from_jax_draws(name):
    """The port trains from explicit initial weights; given the JAX
    package's own `jax.random` draws it lands on JAX's weights."""
    ds = load_dataset(name)
    f, h, c = ds.x_train.shape[1], 16, ds.n_classes
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    w1_init = np.array(jax.random.normal(k1, (f, h), jnp.float32) * f ** -0.5)
    w2_init = np.array(jax.random.normal(k2, (h, c), jnp.float32) * h ** -0.5)
    jw1, jw2 = j_pm.train_mlp(ds.x_train, ds.y_train, c, n_hidden=h)
    tw1, tw2 = t_pm.train_mlp(ds.x_train, ds.y_train,
                              torch.as_tensor(w1_init),
                              torch.as_tensor(w2_init))
    for got, want in ((tw1, jw1), (tw2, jw2)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        scale = np.abs(want.astype(np.float64)).max() / 7
        ratio = want.astype(np.float64) / scale
        clear = np.abs(np.abs(ratio - np.floor(ratio)) - 0.5) > 1e-4
        np.testing.assert_array_equal(t_pm.quantize_master(got)[clear],
                                      j_pm.quantize_master(want)[clear])


# ---------------------------------------------------------------------------
# fitness
# ---------------------------------------------------------------------------

def _spy_qmatmul(monkeypatch):
    """Record the dtype and row stride of every x the kernel route hands
    `kernels.ops.qmatmul`."""
    from repro_torch.kernels import ops as t_kops
    seen = []
    real = t_kops.qmatmul

    def spy(x, w_q, scale):
        seen.append((x.dtype, x.stride()))
        return real(x, w_q, scale)

    monkeypatch.setattr(t_kops, "qmatmul", spy)
    return seen


@pytest.mark.parametrize("hidden", [4, 16])
def test_objectives_match_jax(problems, hidden, monkeypatch):
    jp, tp = problems[hidden]
    pop = _random_pop(hidden, 16, jp.n_genes, jp.exact_genes())
    ref = t_pm.make_reference_fitness(tp)(torch.as_tensor(pop)).numpy()
    seen = _spy_qmatmul(monkeypatch)
    ker = t_pm.make_kernel_fitness(tp)(torch.as_tensor(pop)).numpy()
    # the kernel route feeds qmatmul the uint8 codes, rows 16-byte aligned
    assert [d for d, _ in seen] == [torch.uint8]
    assert seen[0][1][1] == 1 and seen[0][1][0] % 16 == 0
    np.testing.assert_array_equal(tp.x8u.numpy(), jp.x8)
    np.testing.assert_array_equal(ker, ref)   # plain qmatmul on the CPU
    np.testing.assert_array_equal(ref[0], [0.0, 1.0])
    unjitted = np.asarray(j_pm.population_objectives(jp.operands,
                                                     jnp.asarray(pop)))
    jitted = np.asarray(j_pm.make_reference_fitness(jp)(jnp.asarray(pop)))
    np.testing.assert_array_equal(ref[:, 0], unjitted[:, 0])
    np.testing.assert_array_equal(ker[:, 0], unjitted[:, 0])
    assert np.abs(ref[:, 0] - jitted[:, 0]).max() <= 2.0 ** -23
    for want in (unjitted, jitted):
        assert (np.abs(ref[:, 1] - want[:, 1])
                <= AREA_TOL * np.maximum(1, want[:, 1])).all()
    # the area is the integer-quanta sum, exactly
    combos = t_pm.decode_combos(torch.as_tensor(pop)).numpy()
    h = tp.n_hidden
    units = (tp.cost1.numpy()[combos[:, :h], np.arange(h)].sum(-1)
             + tp.cost2.numpy()[combos[:, h:], np.arange(tp.n_classes)]
             .sum(-1))
    np.testing.assert_array_equal(
        ref[:, 1], units.astype(np.float32) / np.float32(tp.exact_units))


def test_kernel_predict_equals_predict_master(problems, monkeypatch):
    jp, tp = problems[16]
    seen = _spy_qmatmul(monkeypatch)
    predict = t_pm.make_kernel_predict(tp)
    for g in _random_pop(3, 4, jp.n_genes, jp.exact_genes()):
        bits, margin = t_pm.decode_design(g)
        w1 = t_pm.effective_weights(jp.w1_master, bits[:16], margin[:16])
        w2 = t_pm.effective_weights(jp.w2_master, bits[16:], margin[16:])
        np.testing.assert_array_equal(
            predict(torch.as_tensor(g)).numpy(),
            j_pm.predict_master(w1, w2, jp.shift, jp.x8))
    assert seen and all(d == torch.uint8 for d, _ in seen)


# ---------------------------------------------------------------------------
# netlist, Verilog, simulation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hidden", [4, 16])
def test_mlp_netlist_and_verilog_match_jax(problems, hidden):
    jp, _ = problems[hidden]
    pop = _random_pop(7 + hidden, 3, jp.n_genes, jp.exact_genes())
    for i, g in enumerate(pop):
        bits, margin = j_pm.decode_design(g)
        w1 = j_pm.effective_weights(jp.w1_master, bits[:hidden],
                                    margin[:hidden])
        w2 = j_pm.effective_weights(jp.w2_master, bits[hidden:],
                                    margin[hidden:])
        jc = j_netlist.build_mlp_circuit(w1, w2, jp.shift, jp.n_classes)
        tc = t_netlist.build_mlp_circuit(w1, w2, jp.shift, jp.n_classes)
        for f in ("op", "a", "b"):
            np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
        assert tc.out_bits == jc.out_bits
        assert t_netlist.gate_counts(tc) == j_netlist.gate_counts(jc)
        assert (t_rtl.emit_circuit_verilog(tc, "printed_mlp")
                == j_rtl.emit_circuit_verilog(jc, "printed_mlp"))
        sim = t_netlist.simulate(tc, torch.as_tensor(jp.x8)).numpy()
        np.testing.assert_array_equal(
            sim, j_pm.predict_master(w1, w2, jp.shift, jp.x8))
        np.testing.assert_array_equal(
            sim, j_faults.simulate_faulty_serial(jc, jp.x8))
        if hidden == 4 and i == 1:  # the jnp simulator: seconds a circuit
            np.testing.assert_array_equal(
                sim, np.asarray(j_netlist.simulate(jc, jp.x8)))


def test_builder_arithmetic_matches_jax():
    """The vector arithmetic cells build the same gates in both packages
    and compute what they name."""
    for cls in (t_netlist.NetlistBuilder, j_netlist.NetlistBuilder):
        nb = cls()
        a = [nb.input_bit(0, i) for i in range(4)]
        b = [nb.input_bit(1, i) for i in range(3)]
        s = nb.add(a, b)
        d = nb.sub(a, b)
        g = nb.gt(a, b)
        m = nb.mux_vec(g, a, b)
        t = nb.sum_vecs([a, b, nb.const_vec(5, 3)])
        x = nb.xor_(a[0], b[0])
        if cls is t_netlist.NetlistBuilder:
            port = (list(nb.op), list(nb.a), list(nb.b), s, d, g, m, t, x)
        else:
            assert port == (list(nb.op), list(nb.a), list(nb.b), s, d, g, m,
                            t, x)
    circuit = t_netlist.Circuit(
        op=np.asarray(port[0], np.int8), a=np.asarray(port[1], np.int32),
        b=np.asarray(port[2], np.int32), out_bits=(), trees=[], n_classes=1)
    codes = np.array([[va, vb] for va in range(16) for vb in range(8)])

    def value(bits):
        out = np.zeros(len(codes), np.int64)
        for i, w in enumerate(bits):
            out |= t_netlist.simulate(
                t_netlist.Circuit(circuit.op, circuit.a, circuit.b, (w,), [],
                                  2), codes).numpy().astype(np.int64) << i
        return out

    va, vb = codes[:, 0], codes[:, 1]
    s, d, g, m, t, x = port[3:]
    np.testing.assert_array_equal(value(s), va + vb)
    np.testing.assert_array_equal(value(d)[va >= vb], (va - vb)[va >= vb])
    np.testing.assert_array_equal(value([g]), va > vb)
    np.testing.assert_array_equal(value(m), np.where(va > vb, va, vb))
    np.testing.assert_array_equal(value(t), va + vb + 5)
    np.testing.assert_array_equal(value([x]), (va ^ vb) & 1)


# ---------------------------------------------------------------------------
# search, artifacts and serving across the two packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def searched(problems, tmp_path_factory):
    """pareto.json paths: one written by the port (kernel backend,
    verify_rtl, emit_rtl) and one by the JAX package (reference backend,
    no verify_rtl: its kernel leg is the Pallas call)."""
    root = tmp_path_factory.mktemp("torch_mlp")
    jp, tp = problems[4]
    t_out = str(root / "port")
    result = t_search.run_search(tp, backend="kernel", pop_size=8,
                                 n_generations=2, seed=0, dataset="seeds",
                                 out_dir=t_out, verify_rtl=True,
                                 emit_rtl=True)
    j_out = str(root / "jax")
    j_search.run_search(jp, backend="reference", pop_size=8,
                        n_generations=2, seed=0, dataset="seeds",
                        out_dir=j_out)
    return dict(port=t_out + "/pareto.json", jax=j_out + "/pareto.json",
                result=result)


def test_port_search_scores_exact_design_and_verifies(problems, searched):
    _, tp = problems[4]
    objs = searched["result"].pareto_objs
    assert bool(((objs[:, 0] <= 0) & (objs[:, 1] <= 1)).any())
    fit = t_pm.make_kernel_fitness(tp)
    assert fit(torch.as_tensor(tp.exact_genes())[None]).tolist() == [[0.0,
                                                                      1.0]]
    with open(searched["port"]) as fh:
        payload = json.load(fh)
    assert payload["family"] == "mlp" and payload["rtl_verified"]
    assert all(p["verified"] for p in payload["pareto"])
    rtl_dir = pathlib.Path(searched["port"]).parent
    assert all((rtl_dir / p["rtl"]).exists() for p in payload["pareto"])


def test_port_artifact_loads_in_jax(problems, searched):
    jp, _ = problems[4]
    j_art = j_search.load_pareto_artifact(searched["port"])
    t_art = t_search.load_pareto_artifact(searched["port"])
    assert j_art.family == t_art.family == "mlp"
    np.testing.assert_array_equal(j_art.w1_master, jp.w1_master)
    assert j_art.n_hidden == 4 and len(j_art.points) == len(t_art.points)
    for i in range(len(t_art.points)):
        for a, b in zip(t_art.point_design(i), j_art.point_design(i)):
            np.testing.assert_array_equal(a, b)
        assert t_art.point_accuracy(i) == j_art.point_accuracy(i)
    assert t_art.best_under_loss(0.01) == j_art.best_under_loss(0.01)


def test_jax_artifact_served_by_port_equals_jax_server(searched, monkeypatch):
    seen = _spy_qmatmul(monkeypatch)
    j_art = j_search.load_pareto_artifact(searched["jax"])
    t_art = t_artifact.load_pareto_artifact(searched["jax"])
    assert t_art.family == "mlp"
    ds = load_dataset("seeds")
    x = np.asarray(ds.x_test)
    for i in range(len(t_art.points)):
        j_served = JaxServer.from_artifact(j_art, point=i,
                                           backend="reference").classify(x)
        circuit = t_families.get_family("mlp").build_point_circuit(t_art, i)
        for backend in BACKENDS:
            server = ClassifyServer.from_artifact(t_art, point=i,
                                                  backend=backend,
                                                  device="cpu")
            served = server.classify(x)
            np.testing.assert_array_equal(served, j_served, err_msg=backend)
            acc = float((served == ds.y_test).mean())
            assert abs(acc - t_art.point_accuracy(i)) <= 1e-6
        np.testing.assert_array_equal(
            t_netlist.simulate(circuit, server.featurize(x)).numpy(),
            j_served)
    # the kernel backend serves from uint8 codes in 16-byte aligned rows
    assert seen and all(d == torch.uint8 and st[0] % 16 == 0
                        for d, st in seen)
    # odd request sizes through the buckets, and out-of-grid codes wrap
    codes = server.featurize(x).astype(np.int32)
    for rows in (1, 5, 37):
        np.testing.assert_array_equal(server.classify(codes[:rows]),
                                      j_served[:rows])
    np.testing.assert_array_equal(server.classify(codes[:9] + 256),
                                  j_served[:9])


def test_family_registry_matches_jax(problems):
    jp, tp = problems[4]
    assert set(t_families.FAMILIES) == set(j_families.FAMILIES)
    assert t_families.family_of(tp).name == "mlp"
    assert j_families.family_of(jp).name == "mlp"
    for fn in (t_families.get_family, j_families.get_family):
        with pytest.raises(ValueError) as err:
            fn("forest")
        if fn is t_families.get_family:
            t_msg = str(err.value)
    assert t_msg == str(err.value)
    for fn in (t_families.family_of, j_families.family_of):
        with pytest.raises(TypeError) as err:
            fn(object())
        assert str(err.value) == "no registered classifier family owns object"
    for mod in (t_families, j_families):
        assert mod.family_of_payload({}).name == "tree"
        assert mod.family_of_payload({"family": "mlp"}).name == "mlp"
    assert (t_families.get_family("mlp").describe(tp)
            == j_families.get_family("mlp").describe(jp))
    with pytest.raises(ValueError, match="unknown fitness backend"):
        t_search.make_fitness(tp, "islands")
    with pytest.raises(ValueError, match="unknown classifier family"):
        t_artifact.from_payload({"family": "forest"})


def test_default_device_raises_without_gpu(monkeypatch, problems):
    jp, _ = problems[4]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CudaUnavailableError):
        t_pm.build_problem("seeds", n_hidden=4)
    with pytest.raises(CudaUnavailableError):
        convert.mlp_problem_from_arrays(jp.w1_master, jp.w2_master, jp.shift,
                                        jp.n_classes, jp.x8, jp.y)
    with pytest.raises(CudaUnavailableError):
        ClassifyServer.for_mlp(jp.w1_master, jp.w2_master, jp.shift,
                               jp.n_classes)


def test_cli_mlp_search_then_serve(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = str(tmp_path / "run")
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.search", "--family", "mlp",
         "--dataset", "seeds", "--backend", "kernel", "--pop", "8",
         "--gens", "2", "--out", out, "--verify-rtl", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "seeds mlp: features=7 hidden=16" in run.stdout
    assert "RTL verified" in run.stdout
    assert os.path.exists(os.path.join(out, "bespoke_seeds.v"))
    serve = subprocess.run(
        [sys.executable, "-m", "repro_torch.search", "serve", "--pareto",
         out + "/pareto.json", "--device", "cpu", "--verify-netlist",
         "--batch", "37"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert serve.returncode == 0, serve.stdout + serve.stderr
    assert "printed MLP 7-16-3" in serve.stdout
    assert "served predictions equal the gate-level simulation" in serve.stdout
