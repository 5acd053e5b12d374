"""Parity of the port's stuck-at fault simulator (`repro_torch.core.faults`)
with the JAX package's (`repro.core.faults`), on the CPU.

Four circuits, each built in both packages from the same trees or
weights, over 32 test vectors: a `seeds` tree, a three-tree `vertebral`
forest under both vote adders (`exact` and `approx`) and a small
integer MLP (3-4-3). The port's fault sites, lanes, zero-fault lane,
exhaustive single stuck-at predictions, Monte-Carlo lanes (JAX's draws),
chunking, shape errors and numpy oracle are held to the JAX package's.

Tolerance: exact equality everywhere (predictions are integers, sites and
lanes are integer and string records).
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.core import faults as j_faults
from repro.core import forest as j_forest
from repro.core import netlist as j_netlist
from repro.core import quant as j_quant
from repro.core.train import train_tree as j_train_tree
from repro.core.tree import to_parallel as j_to_parallel
from repro.datasets import load_dataset, quantize_u8
from repro_torch.core import faults as t_faults
from repro_torch.core import forest as t_forest
from repro_torch.core import netlist as t_netlist
from repro_torch.core.train import train_tree as t_train_tree
from repro_torch.core.tree import to_parallel as t_to_parallel
from repro_torch.device import CudaUnavailableError

N_VECTORS = 32
MC_TRIALS = 32


def _tree_circuits(dataset: str, n_trees: int, vote_adder: str = "exact"):
    """(JAX circuit, port circuit, x8, y): both packages' trees (or
    forests) of ``dataset`` lowered at the same random precisions."""
    ds = load_dataset(dataset)
    if n_trees <= 1:
        j_pt = [j_to_parallel(j_train_tree(ds.x_train, ds.y_train,
                                           ds.n_classes))]
        t_pt = [t_to_parallel(t_train_tree(ds.x_train, ds.y_train,
                                           ds.n_classes))]
    else:
        j_pt = j_forest.train_forest(ds.x_train, ds.y_train, ds.n_classes,
                                     n_trees=n_trees).ptrees
        t_pt = t_forest.train_forest(ds.x_train, ds.y_train, ds.n_classes,
                                     n_trees=n_trees).ptrees
    n = sum(p.n_comparators for p in j_pt)
    rng = np.random.default_rng(n_trees)
    bits = rng.integers(j_quant.MIN_BITS, j_quant.MAX_BITS + 1, n)
    thr = np.concatenate([p.threshold for p in j_pt])
    t_int = np.asarray(j_quant.threshold_to_int(thr, bits))
    jc = j_netlist.build_circuit(j_pt, bits, t_int, ds.n_classes,
                                 vote_adder=vote_adder)
    tc = t_netlist.build_circuit(t_pt, bits, t_int, ds.n_classes,
                                 vote_adder=vote_adder)
    x8 = quantize_u8(ds.x_test)[:N_VECTORS]
    y = np.asarray(ds.y_test[:N_VECTORS], np.int64)
    return jc, tc, x8, y


def _mlp_circuits():
    """The JAX test suite's tiny integer MLP, in both packages."""
    rng = np.random.default_rng(3)
    f, h, c = 3, 4, 3
    w1 = rng.integers(-3, 4, (f, h))
    w2 = rng.integers(-3, 4, (h, c))
    x8 = quantize_u8(rng.uniform(0, 1, (N_VECTORS, f)).astype(np.float32))
    y = rng.integers(0, c, N_VECTORS).astype(np.int64)
    return (j_netlist.build_mlp_circuit(w1, w2, 4, c),
            t_netlist.build_mlp_circuit(w1, w2, 4, c), x8, y)


CIRCUITS = {
    "tree": lambda: _tree_circuits("seeds", 1),
    "forest_exact": lambda: _tree_circuits("vertebral", 3, "exact"),
    "forest_approx": lambda: _tree_circuits("vertebral", 3, "approx"),
    "mlp": _mlp_circuits,
}


@pytest.fixture(scope="module", params=sorted(CIRCUITS))
def case(request):
    """(JAX circuit, port circuit, x8, y, JAX simulator, port simulator,
    (gates, values) of every single-fault lane)."""
    jc, tc, x8, y = CIRCUITS[request.param]()
    lanes = j_faults.single_fault_lanes(jc)
    return (jc, tc, x8, y, j_faults.FaultSimulator(jc),
            t_faults.FaultSimulator(tc, device="cpu"), lanes)


@pytest.fixture(scope="module")
def jax_sites_preds(case):
    """JAX's exhaustive single stuck-at predictions of ``case``."""
    _, _, x8, _, jsim, _, (gates, values) = case
    return jsim.run_sites(x8, gates, values)


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


# --- circuits, sites and lanes ----------------------------------------------

def test_circuits_equal_gate_for_gate(case):
    jc, tc, *_ = case
    for f in ("op", "a", "b"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
    assert tc.out_bits == jc.out_bits


def test_fault_sites_equal_jax(case):
    jc, tc, *_ = case
    fields = ("gate", "kind", "op", "label", "feature", "bit")
    want = [tuple(getattr(s, f) for f in fields)
            for s in j_faults.enumerate_fault_sites(jc)]
    got = [tuple(getattr(s, f) for f in fields)
           for s in t_faults.enumerate_fault_sites(tc)]
    assert got == want and len(got) > 0


def test_single_fault_lanes_equal_jax(case):
    jc, tc, *_ = case
    for want, got in zip(j_faults.single_fault_lanes(jc),
                         t_faults.single_fault_lanes(tc)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_site_masks_and_auto_chunk_equal_jax(case):
    jc, tc, x8, *_ = case
    gates, values = t_faults.single_fault_lanes(tc)
    for want, got in zip(j_faults.site_masks(jc.n_gates, gates, values),
                         t_faults.site_masks(tc.n_gates, gates, values)):
        np.testing.assert_array_equal(got, want)
    for n in (1, x8.shape[0], 3090, 10**7):
        for budget in (t_faults.DEFAULT_CHUNK_BUDGET_BYTES, 1 << 30):
            assert t_faults.auto_chunk(tc, n, budget) == \
                j_faults.auto_chunk(jc, n, budget)
    assert t_faults.DEFAULT_CHUNK_BUDGET_BYTES == \
        j_faults.DEFAULT_CHUNK_BUDGET_BYTES == 64 << 20
    assert t_faults.MAX_CHUNK == j_faults.MAX_CHUNK == 256


def test_default_chunk_budgets_the_packed_table(case, jax_sites_preds,
                                                monkeypatch):
    """`run_masks`' default chunk is `packed_chunk`: the port's (G, chunk,
    ceil(B / 8)) uint8 value table under the budget, clamped to [1,
    MAX_CHUNK], never fewer lanes than the reference's `auto_chunk`."""
    _, tc, x8, _, _, tsim, (gates, values) = case
    for n in (1, 8, 9, x8.shape[0], 3090, 10**7):
        for budget in (t_faults.DEFAULT_CHUNK_BUDGET_BYTES, 1 << 30, 1):
            got = t_faults.packed_chunk(tc, n, budget)
            assert got == int(np.clip(budget // (-(-n // 8) * tc.n_gates),
                                      1, t_faults.MAX_CHUNK))
            assert got >= t_faults.auto_chunk(tc, n, budget)
    seen = []
    monkeypatch.setattr(t_faults, "packed_chunk",
                        lambda circuit, n: seen.append((circuit, n)) or 5)
    step = tsim._chunk_step
    chunks = []
    monkeypatch.setattr(tsim, "_chunk_step", lambda base, chunk, n_b: (
        chunks.append(chunk), step(base, chunk, n_b))[1])
    np.testing.assert_array_equal(tsim.run_sites(x8, gates, values),
                                  jax_sites_preds)
    assert seen == [(tc, x8.shape[0])] and chunks == [min(5, len(gates))]


# --- the simulator against the JAX package ------------------------------------

def test_zero_fault_lane_equals_jax_simulate(case):
    jc, _, x8, _, _, tsim, _ = case
    got = tsim.run_zero_fault(x8)
    assert got.dtype == np.int32 and got.shape == (x8.shape[0],)
    np.testing.assert_array_equal(got, np.asarray(j_netlist.simulate(jc, x8)))
    np.testing.assert_array_equal(got, t_netlist.simulate(
        tsim.circuit, torch.as_tensor(x8)).numpy())


def test_exhaustive_single_stuck_at_equals_jax(case, jax_sites_preds):
    """Every (site, polarity) lane equals the JAX `FaultSimulator` and the
    JAX serial per-gate oracle, array for array."""
    jc, _, x8, _, _, tsim, (gates, values) = case
    got = tsim.run_sites(x8, gates, values, chunk=17)   # pad-and-crop path
    assert got.dtype == np.int32 and got.shape == (len(gates), x8.shape[0])
    np.testing.assert_array_equal(got, jax_sites_preds)
    for i in range(len(gates)):
        np.testing.assert_array_equal(
            got[i], j_faults.simulate_faulty_serial(
                jc, x8, [(gates[i], values[i])]),
            err_msg=f"lane {i}: gate {gates[i]} stuck-at-{values[i]}")


def test_monte_carlo_masks_equal_jax(case):
    """JAX's 32 Monte-Carlo masks through the port's `run_masks` give the
    JAX `run_masks` predictions."""
    jc, _, x8, _, jsim, tsim, _ = case
    sites = j_faults.enumerate_fault_sites(jc)
    site_gates = np.asarray([s.gate for s in sites])
    hit, pol = _jax_draws(len(sites), MC_TRIALS, 0.05, seed=0)
    mask = np.zeros((MC_TRIALS, jc.n_gates), bool)
    val = np.zeros_like(mask)
    mask[:, site_gates] = hit
    val[:, site_gates] = hit & pol
    assert mask.sum() > 0
    np.testing.assert_array_equal(tsim.run_masks(x8, mask, val),
                                  jsim.run_masks(x8, mask, val))


@pytest.mark.parametrize("chunk", [1, 3, None], ids=["1", "3", "auto"])
def test_chunking_is_invisible(case, jax_sites_preds, chunk):
    _, _, x8, _, _, tsim, (gates, values) = case
    np.testing.assert_array_equal(
        tsim.run_sites(x8, gates, values, chunk=chunk), jax_sites_preds)


def test_chunk_larger_than_lanes_and_no_lanes(case, jax_sites_preds):
    _, tc, x8, _, _, tsim, (gates, values) = case
    np.testing.assert_array_equal(
        tsim.run_sites(x8, gates, values, chunk=len(gates) + 100),
        jax_sites_preds)
    empty = np.zeros((0, tc.n_gates), bool)
    got = tsim.run_masks(x8, empty, empty)
    assert got.shape == (0, x8.shape[0]) and got.dtype == np.int32


@pytest.mark.parametrize("bad", ["mask_width", "value_rows", "site_values"])
def test_shape_validation_raises_jax_errors(bad):
    """The same `ValueError`s, word for word, as the JAX package."""
    jc, tc, x8, _ = _tree_circuits("seeds", 1)
    g = tc.n_gates
    masks = {"mask_width": (np.zeros((2, g + 1), bool),) * 2,
             "value_rows": (np.zeros((2, g), bool), np.zeros((3, g), bool))}
    msgs = []
    for mod, sim in ((t_faults, lambda: t_faults.FaultSimulator(tc, "cpu")),
                     (j_faults, lambda: j_faults.FaultSimulator(jc))):
        with pytest.raises(ValueError) as exc:
            if bad == "site_values":
                mod.site_masks(g, [2, 3], [0])
            else:
                sim().run_masks(x8, *masks[bad])
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


# --- the numpy oracle ---------------------------------------------------------

def test_serial_oracle_equals_jax(case):
    """The port's numpy oracle equals JAX's, fault-free and under random
    sets of 1-4 faults."""
    jc, tc, x8, *_ = case
    sites = t_faults.enumerate_fault_sites(tc)
    rng = np.random.default_rng(7)
    np.testing.assert_array_equal(t_faults.simulate_faulty_serial(tc, x8),
                                  j_faults.simulate_faulty_serial(jc, x8))
    for _ in range(8):
        k = int(rng.integers(1, 5))
        chosen = rng.choice(len(sites), size=k, replace=False)
        pairs = [(sites[s].gate, int(v))
                 for s, v in zip(chosen, rng.integers(0, 2, k))]
        np.testing.assert_array_equal(
            t_faults.simulate_faulty_serial(tc, x8, pairs),
            j_faults.simulate_faulty_serial(jc, x8, pairs))


def test_multi_fault_lanes_equal_serial_oracle(case):
    """Multi-hot masks (the Monte-Carlo shape) equal the port's numpy
    oracle applying the same fault set."""
    _, tc, x8, _, _, tsim, _ = case
    sites = t_faults.enumerate_fault_sites(tc)
    rng = np.random.default_rng(11)
    mask = np.zeros((6, tc.n_gates), bool)
    val = np.zeros_like(mask)
    pairs = []
    for t in range(6):
        chosen = rng.choice(len(sites), size=min(3, len(sites)),
                            replace=False)
        vals = rng.integers(0, 2, len(chosen))
        pairs.append([(sites[s].gate, int(v)) for s, v in zip(chosen, vals)])
        for g, v in pairs[-1]:
            mask[t, g], val[t, g] = True, bool(v)
    got = tsim.run_masks(x8, mask, val, chunk=4)
    for t in range(6):
        np.testing.assert_array_equal(
            got[t], t_faults.simulate_faulty_serial(tc, x8, pairs[t]))


# --- devices ------------------------------------------------------------------

def test_device_is_explicit():
    """`device="cpu"` runs on the CPU, tensors in or out; the default is
    cuda, which raises without a GPU instead of falling back."""
    _, tc, x8, _ = _tree_circuits("seeds", 1)
    sim = t_faults.FaultSimulator(tc, device="cpu")
    assert sim.device == torch.device("cpu")
    np.testing.assert_array_equal(
        sim.run_zero_fault(torch.as_tensor(x8)), sim.run_zero_fault(x8))
    if torch.cuda.is_available():
        assert t_faults.FaultSimulator(tc).device.type == "cuda"
    else:
        with pytest.raises(CudaUnavailableError):
            t_faults.FaultSimulator(tc)
