"""Parity of the port's stuck-at fault simulator (`repro_torch.core.faults`)
with the JAX package's (`repro.core.faults`), on the CPU; and, on a CUDA
machine, the simulator's kernel (`kernels.fault_sim.fault_lanes`) held to
its plain version and to the numpy oracle.

Four circuits, each built in both packages from the same trees or
weights, over 32 test vectors: a `seeds` tree, a three-tree `vertebral`
forest under both vote adders (`exact` and `approx`) and a small
integer MLP (3-4-3). The port's fault sites, lanes, zero-fault lane,
exhaustive single stuck-at predictions, Monte-Carlo lanes (JAX's draws),
chunking, shape errors and numpy oracle are held to the JAX package's.

The plain version of the kernel's wrapper (the CPU simulator's level chain
over its operands) and the wrapper's checks run on the CPU. The card tests
(``-m torch_cuda``) build their circuits with the port alone: the same
four, the har tree over its 3,090 test rows, and random circuits up to the
last gate count whose lane state fits in shared memory and past it (the
global-scratch path).

The JAX package is imported by a fixture, not at the top: the machine with
the card has no JAX, and runs this file's card tests alone with
``python -m pytest -m torch_cuda tests/test_torch_faults.py``.

Tolerance: exact equality everywhere (predictions are integers, sites and
lanes are integer and string records).
"""
from __future__ import annotations

import re
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import faults as t_faults
from repro_torch.core import forest as t_forest
from repro_torch.core import netlist as t_netlist
from repro_torch.core import quant as t_quant
from repro_torch.core.train import train_tree as t_train_tree
from repro_torch.core.tree import to_parallel as t_to_parallel
from repro_torch.datasets import load_dataset as t_load_dataset
from repro_torch.datasets import quantize_u8 as t_quantize_u8
from repro_torch.device import CudaUnavailableError
from repro_torch.kernels import _build
from repro_torch.kernels import fault_sim
from repro_torch.runtime import trace

N_VECTORS = 32
MC_TRIALS = 32


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules this file holds the port to."""
    jax = pytest.importorskip("jax")
    from repro.core import faults, forest, netlist, quant
    from repro.core.train import train_tree
    from repro.core.tree import to_parallel
    from repro.datasets import load_dataset, quantize_u8
    return types.SimpleNamespace(
        jax=jax, faults=faults, forest=forest, netlist=netlist, quant=quant,
        train_tree=train_tree, to_parallel=to_parallel,
        load_dataset=load_dataset, quantize_u8=quantize_u8)


def _tree_circuits(jx, dataset: str, n_trees: int, vote_adder: str = "exact"):
    """(JAX circuit, port circuit, x8, y): both packages' trees (or
    forests) of ``dataset`` lowered at the same random precisions."""
    ds = jx.load_dataset(dataset)
    if n_trees <= 1:
        j_pt = [jx.to_parallel(jx.train_tree(ds.x_train, ds.y_train,
                                             ds.n_classes))]
        t_pt = [t_to_parallel(t_train_tree(ds.x_train, ds.y_train,
                                           ds.n_classes))]
    else:
        j_pt = jx.forest.train_forest(ds.x_train, ds.y_train, ds.n_classes,
                                      n_trees=n_trees).ptrees
        t_pt = t_forest.train_forest(ds.x_train, ds.y_train, ds.n_classes,
                                     n_trees=n_trees).ptrees
    n = sum(p.n_comparators for p in j_pt)
    rng = np.random.default_rng(n_trees)
    bits = rng.integers(jx.quant.MIN_BITS, jx.quant.MAX_BITS + 1, n)
    thr = np.concatenate([p.threshold for p in j_pt])
    t_int = np.asarray(jx.quant.threshold_to_int(thr, bits))
    jc = jx.netlist.build_circuit(j_pt, bits, t_int, ds.n_classes,
                                  vote_adder=vote_adder)
    tc = t_netlist.build_circuit(t_pt, bits, t_int, ds.n_classes,
                                 vote_adder=vote_adder)
    x8 = jx.quantize_u8(ds.x_test)[:N_VECTORS]
    y = np.asarray(ds.y_test[:N_VECTORS], np.int64)
    return jc, tc, x8, y


MLP_SHAPE = (3, 4, 3)   # the JAX test suite's tiny integer MLP


def _mlp_weights():
    rng = np.random.default_rng(3)
    f, h, c = MLP_SHAPE
    w1 = rng.integers(-3, 4, (f, h))
    w2 = rng.integers(-3, 4, (h, c))
    return rng, w1, w2


def _mlp_circuits(jx):
    """The JAX test suite's tiny integer MLP, in both packages."""
    rng, w1, w2 = _mlp_weights()
    f, _, c = MLP_SHAPE
    x8 = jx.quantize_u8(rng.uniform(0, 1, (N_VECTORS, f)).astype(np.float32))
    y = rng.integers(0, c, N_VECTORS).astype(np.int64)
    return (jx.netlist.build_mlp_circuit(w1, w2, 4, c),
            t_netlist.build_mlp_circuit(w1, w2, 4, c), x8, y)


CIRCUITS = {
    "tree": lambda jx: _tree_circuits(jx, "seeds", 1),
    "forest_exact": lambda jx: _tree_circuits(jx, "vertebral", 3, "exact"),
    "forest_approx": lambda jx: _tree_circuits(jx, "vertebral", 3, "approx"),
    "mlp": _mlp_circuits,
}


@pytest.fixture(scope="module", params=sorted(CIRCUITS))
def case(request, jx):
    """(JAX circuit, port circuit, x8, y, JAX simulator, port simulator,
    (gates, values) of every single-fault lane)."""
    jc, tc, x8, y = CIRCUITS[request.param](jx)
    lanes = jx.faults.single_fault_lanes(jc)
    return (jc, tc, x8, y, jx.faults.FaultSimulator(jc),
            t_faults.FaultSimulator(tc, device="cpu"), lanes)


@pytest.fixture(scope="module")
def jax_sites_preds(case):
    """JAX's exhaustive single stuck-at predictions of ``case``."""
    _, _, x8, _, jsim, _, (gates, values) = case
    return jsim.run_sites(x8, gates, values)


def _jax_draws(jx, n_sites: int, n_trials: int, defect_rate: float,
               seed: int):
    """The (T, S) hit and polarity masks of `repro.search.robustness.
    monte_carlo`, drawn the way it draws them."""
    jax = jx.jax
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


def test_fault_sites_equal_jax(case, jx):
    jc, tc, *_ = case
    fields = ("gate", "kind", "op", "label", "feature", "bit")
    want = [tuple(getattr(s, f) for f in fields)
            for s in jx.faults.enumerate_fault_sites(jc)]
    got = [tuple(getattr(s, f) for f in fields)
           for s in t_faults.enumerate_fault_sites(tc)]
    assert got == want and len(got) > 0


def test_single_fault_lanes_equal_jax(case, jx):
    jc, tc, *_ = case
    for want, got in zip(jx.faults.single_fault_lanes(jc),
                         t_faults.single_fault_lanes(tc)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_site_masks_and_auto_chunk_equal_jax(case, jx):
    jc, tc, x8, *_ = case
    gates, values = t_faults.single_fault_lanes(tc)
    for want, got in zip(jx.faults.site_masks(jc.n_gates, gates, values),
                         t_faults.site_masks(tc.n_gates, gates, values)):
        np.testing.assert_array_equal(got, want)
    for n in (1, x8.shape[0], 3090, 10**7):
        for budget in (t_faults.DEFAULT_CHUNK_BUDGET_BYTES, 1 << 30):
            assert t_faults.auto_chunk(tc, n, budget) == \
                jx.faults.auto_chunk(jc, n, budget)
    assert t_faults.DEFAULT_CHUNK_BUDGET_BYTES == \
        jx.faults.DEFAULT_CHUNK_BUDGET_BYTES == 64 << 20
    assert t_faults.MAX_CHUNK == jx.faults.MAX_CHUNK == 256


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

def test_zero_fault_lane_equals_jax_simulate(case, jx):
    jc, _, x8, _, _, tsim, _ = case
    got = tsim.run_zero_fault(x8)
    assert got.dtype == np.int32 and got.shape == (x8.shape[0],)
    np.testing.assert_array_equal(got, np.asarray(jx.netlist.simulate(jc, x8)))
    np.testing.assert_array_equal(got, t_netlist.simulate(
        tsim.circuit, torch.as_tensor(x8)).numpy())


def test_exhaustive_single_stuck_at_equals_jax(case, jax_sites_preds, jx):
    """Every (site, polarity) lane equals the JAX `FaultSimulator` and the
    JAX serial per-gate oracle, array for array."""
    jc, _, x8, _, _, tsim, (gates, values) = case
    got = tsim.run_sites(x8, gates, values, chunk=17)   # pad-and-crop path
    assert got.dtype == np.int32 and got.shape == (len(gates), x8.shape[0])
    np.testing.assert_array_equal(got, jax_sites_preds)
    for i in range(len(gates)):
        np.testing.assert_array_equal(
            got[i], jx.faults.simulate_faulty_serial(
                jc, x8, [(gates[i], values[i])]),
            err_msg=f"lane {i}: gate {gates[i]} stuck-at-{values[i]}")


def test_monte_carlo_masks_equal_jax(case, jx):
    """JAX's 32 Monte-Carlo masks through the port's `run_masks` give the
    JAX `run_masks` predictions."""
    jc, _, x8, _, jsim, tsim, _ = case
    sites = jx.faults.enumerate_fault_sites(jc)
    site_gates = np.asarray([s.gate for s in sites])
    hit, pol = _jax_draws(jx, len(sites), MC_TRIALS, 0.05, seed=0)
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
def test_shape_validation_raises_jax_errors(bad, jx):
    """The same `ValueError`s, word for word, as the JAX package."""
    jc, tc, x8, _ = _tree_circuits(jx, "seeds", 1)
    g = tc.n_gates
    masks = {"mask_width": (np.zeros((2, g + 1), bool),) * 2,
             "value_rows": (np.zeros((2, g), bool), np.zeros((3, g), bool))}
    msgs = []
    for mod, sim in ((t_faults, lambda: t_faults.FaultSimulator(tc, "cpu")),
                     (jx.faults, lambda: jx.faults.FaultSimulator(jc))):
        with pytest.raises(ValueError) as exc:
            if bad == "site_values":
                mod.site_masks(g, [2, 3], [0])
            else:
                sim().run_masks(x8, *masks[bad])
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


# --- the numpy oracle ---------------------------------------------------------

def test_serial_oracle_equals_jax(case, jx):
    """The port's numpy oracle equals JAX's, fault-free and under random
    sets of 1-4 faults."""
    jc, tc, x8, *_ = case
    sites = t_faults.enumerate_fault_sites(tc)
    rng = np.random.default_rng(7)
    np.testing.assert_array_equal(t_faults.simulate_faulty_serial(tc, x8),
                                  jx.faults.simulate_faulty_serial(jc, x8))
    for _ in range(8):
        k = int(rng.integers(1, 5))
        chosen = rng.choice(len(sites), size=k, replace=False)
        pairs = [(sites[s].gate, int(v))
                 for s, v in zip(chosen, rng.integers(0, 2, k))]
        np.testing.assert_array_equal(
            t_faults.simulate_faulty_serial(tc, x8, pairs),
            jx.faults.simulate_faulty_serial(jc, x8, pairs))


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

def test_device_is_explicit(jx):
    """`device="cpu"` runs on the CPU, tensors in or out; the default is
    cuda, which raises without a GPU instead of falling back."""
    _, tc, x8, _ = _tree_circuits(jx, "seeds", 1)
    sim = t_faults.FaultSimulator(tc, device="cpu")
    assert sim.device == torch.device("cpu")
    np.testing.assert_array_equal(
        sim.run_zero_fault(torch.as_tensor(x8)), sim.run_zero_fault(x8))
    if torch.cuda.is_available():
        assert t_faults.FaultSimulator(tc).device.type == "cuda"
    else:
        with pytest.raises(CudaUnavailableError):
            t_faults.FaultSimulator(tc)


# --- the kernel's wrapper: plain version and checks, on the CPU ---------------

PORT_CIRCUITS = {"tree": ("seeds", 1, "exact"),
                 "forest_exact": ("vertebral", 3, "exact"),
                 "forest_approx": ("vertebral", 3, "approx"),
                 "mlp": None}


def _port_circuit(name: str, n_rows: int = N_VECTORS):
    """(circuit, x8) of `CIRCUITS`' ``name`` built by the port alone (the
    same trees, precisions and weights), over ``n_rows`` test rows (all of
    them where None)."""
    if PORT_CIRCUITS[name] is None:
        rng, w1, w2 = _mlp_weights()
        f, _, c = MLP_SHAPE
        x8 = t_quantize_u8(rng.uniform(0, 1, (n_rows or N_VECTORS, f))
                           .astype(np.float32))
        return t_netlist.build_mlp_circuit(w1, w2, 4, c), x8
    dataset, n_trees, adder = PORT_CIRCUITS[name]
    ds = t_load_dataset(dataset)
    if n_trees <= 1:
        pts = [t_to_parallel(t_train_tree(ds.x_train, ds.y_train,
                                          ds.n_classes))]
    else:
        pts = t_forest.train_forest(ds.x_train, ds.y_train, ds.n_classes,
                                    n_trees=n_trees).ptrees
    n = sum(p.n_comparators for p in pts)
    bits = np.random.default_rng(n_trees).integers(
        t_quant.MIN_BITS, t_quant.MAX_BITS + 1, n)
    thr = np.concatenate([p.threshold for p in pts])
    t_int = t_quant.threshold_to_int(torch.as_tensor(thr),
                                     torch.as_tensor(bits)).numpy()
    circuit = t_netlist.build_circuit(pts, bits, t_int, ds.n_classes,
                                      vote_adder=adder)
    return circuit, t_quantize_u8(ds.x_test)[:n_rows]


def _random_circuit(n_gates: int, seed: int, n_features: int = 16,
                    window: int = 4096):
    """A random levelized circuit of ``n_gates`` gates: both constants,
    every bit of ``n_features`` features, then NOT, AND, OR and XOR gates
    reading any two earlier gates of the last ``window`` (so its depth
    grows with its size); three output bits among the last gates."""
    rng = np.random.default_rng(seed)
    n_in = 8 * n_features
    op = np.empty(n_gates, np.int8)
    a = np.zeros(n_gates, np.int32)
    b = np.full(n_gates, -1, np.int32)
    op[:2] = (t_netlist.CONST0, t_netlist.CONST1)
    op[2:2 + n_in] = t_netlist.INPUT
    a[2:2 + n_in] = np.repeat(np.arange(n_features), 8)
    b[2:2 + n_in] = np.tile(np.arange(8), n_features)
    for g in range(2 + n_in, n_gates):
        op[g] = rng.choice((t_netlist.NOT, t_netlist.AND, t_netlist.OR,
                            t_netlist.XOR))
        a[g] = rng.integers(max(0, g - window), g)
        if op[g] != t_netlist.NOT:
            b[g] = rng.integers(max(0, g - window), g)
    outs = tuple(int(g) for g in rng.choice(
        np.arange(n_gates - 64, n_gates), 3, replace=False))
    return t_netlist.Circuit(op=op, a=a, b=b, out_bits=outs, trees=[],
                             n_classes=8)


def _host_tables(circuit, device="cpu"):
    base, levels = t_netlist.level_gates(circuit)
    return fault_sim.fault_tables(
        circuit.op, circuit.a, circuit.b, circuit.out_bits, base, levels,
        lambda arr: torch.as_tensor(np.ascontiguousarray(arr),
                                    dtype=torch.int32, device=device))


def _base_words(circuit, x8, device="cpu"):
    """(n_base, W) int32 fault-free words of the base rows, from the serial
    oracle's own reading of the codes."""
    base, _ = t_netlist.level_gates(circuit)
    x8 = np.asarray(x8, np.int64)
    bits = np.zeros((len(base), x8.shape[0]), bool)
    for i, g in enumerate(base):
        if circuit.op[g] == t_netlist.CONST1:
            bits[i] = True
        elif circuit.op[g] == t_netlist.INPUT:
            bits[i] = (x8[:, circuit.a[g]] >> circuit.b[g]) & 1
    return fault_sim.pack_words(torch.as_tensor(bits, device=device))


def _lanes(circuit, n_multi: int, seed: int, every: int = 1):
    """(masks, values, fault lists): every ``every``-th single stuck-at lane,
    then ``n_multi`` lanes of 2-5 faults each."""
    gates, values = t_faults.single_fault_lanes(circuit)
    gates, values = gates[::every], values[::every]
    mask, val = t_faults.site_masks(circuit.n_gates, gates, values)
    faults = [[(int(g), int(v))] for g, v in zip(gates, values)]
    sites = [s.gate for s in t_faults.enumerate_fault_sites(circuit)]
    rng = np.random.default_rng(seed)
    multi_m = np.zeros((n_multi, circuit.n_gates), bool)
    multi_v = np.zeros_like(multi_m)
    for t in range(n_multi):
        chosen = rng.choice(sites, size=int(rng.integers(2, 6)),
                            replace=False)
        pol = rng.integers(0, 2, len(chosen))
        multi_m[t, chosen], multi_v[t, chosen] = True, pol.astype(bool)
        faults.append([(int(g), int(v)) for g, v in zip(chosen, pol)])
    return (np.concatenate([mask, multi_m]), np.concatenate([val, multi_v]),
            faults)


def _serial(circuit, x8, faults, picks):
    return np.stack([t_faults.simulate_faulty_serial(circuit, x8, faults[i])
                     for i in picks])


def _spread(n: int, k: int = 16) -> np.ndarray:
    return np.unique(np.linspace(0, n - 1, k).astype(int))


@pytest.fixture(scope="module", params=sorted(PORT_CIRCUITS))
def port_case(request):
    """(circuit, x8, masks, values, fault lists) of `PORT_CIRCUITS`' circuit:
    every single lane and 8 multi-fault lanes."""
    circuit, x8 = _port_circuit(request.param)
    return (circuit, x8, *_lanes(circuit, 8, seed=5))


def test_plain_lanes_equal_simulator_and_oracle(port_case):
    """The wrapper's plain version over `fault_tables` and `pack_words`
    equals the CPU simulator on every lane and the serial oracle on a
    spread of them."""
    circuit, x8, mask, val, faults = port_case
    before = trace.counters()
    got = fault_sim.fault_lanes(_base_words(circuit, x8),
                                _host_tables(circuit), torch.as_tensor(mask),
                                torch.as_tensor(val), x8.shape[0])
    assert trace.counters().get("launches.fault_lanes", 0) == before.get(
        "launches.fault_lanes", 0)
    assert got.dtype == torch.int32 and got.shape == (len(mask), len(x8))
    sim = t_faults.FaultSimulator(circuit, device="cpu")
    np.testing.assert_array_equal(got.numpy(), sim.run_masks(x8, mask, val))
    picks = np.concatenate([_spread(len(mask) - 8), len(mask) - 8
                            + np.arange(8)])
    np.testing.assert_array_equal(got.numpy()[picks],
                                  _serial(circuit, x8, faults, picks))


@pytest.mark.parametrize("n_gates", [400, 1500, 3000, 6000])
def test_plain_lanes_on_random_circuits(n_gates):
    """Random circuits (any op mix, any wiring): the plain version equals the
    serial oracle, rows not a multiple of 32."""
    circuit = _random_circuit(n_gates, seed=n_gates, window=256)
    x8 = np.random.default_rng(1).integers(0, 256, (45, 16))
    mask, val, faults = _lanes(circuit, 4, seed=2, every=max(1, n_gates // 40))
    got = fault_sim.fault_lanes(_base_words(circuit, x8),
                                _host_tables(circuit), torch.as_tensor(mask),
                                torch.as_tensor(val), x8.shape[0])
    np.testing.assert_array_equal(
        got.numpy(), _serial(circuit, x8, faults, range(len(mask))))


def test_pack_words_places_sample_32w_plus_j_at_bit_j():
    bits = torch.zeros((2, 70), dtype=torch.bool)
    bits[0, [0, 31, 32, 69]] = True
    bits[1, :] = True
    got = fault_sim.pack_words(bits)
    assert got.dtype == torch.int32 and got.shape == (2, fault_sim.BASE_ALIGN)
    assert got[0].tolist()[:3] == [1 - (1 << 31), 1, 1 << 5]
    assert got[1].tolist()[:3] == [-1, -1, (1 << 6) - 1]
    assert not got[:, 3:].any()
    assert fault_sim.pack_words(torch.ones((1, 257), dtype=torch.bool)
                                ).shape == (1, 2 * fault_sim.BASE_ALIGN)


def test_fault_tables_are_level_ordered():
    """Rows are the base gates, then each level's; each gate's operands are
    rows below its own level; a link's truth table is its op's."""
    circuit = _random_circuit(700, seed=3, window=64)
    tables = _host_tables(circuit)
    base, levels = t_netlist.level_gates(circuit)
    order = np.concatenate([base, *levels])
    np.testing.assert_array_equal(order[tables.gate_row.numpy()],
                                  np.arange(circuit.n_gates))
    assert tables.n_base == len(base) and tables.n_gates == circuit.n_gates
    off = tables.level_off.numpy()
    assert off[0] == len(base) and off[-1] == circuit.n_gates
    links = tables.links.numpy().astype(np.int64)
    for lo, hi in zip(off, off[1:]):
        rows = links[lo - len(base):hi - len(base)]
        assert rows[:, 0].max() < lo
        assert (rows[:, 1] & fault_sim.ROW_MASK).max() < lo
    ops = circuit.op[order[len(base):]]
    truth = (links[:, 1] % (1 << 32)) >> fault_sim.TRUTH_SHIFT
    np.testing.assert_array_equal(
        truth, [fault_sim.TRUTH[int(o)] for o in ops])
    for op, fn in ((t_netlist.NOT, lambda a, b: 1 - a),
                   (t_netlist.AND, lambda a, b: a & b),
                   (t_netlist.OR, lambda a, b: a | b),
                   (t_netlist.XOR, lambda a, b: a ^ b)):
        assert fault_sim.TRUTH[op] == sum(fn(a, b) << (2 * a + b)
                                          for a in (0, 1) for b in (0, 1))
    np.testing.assert_array_equal(order[tables.out_rows.numpy()],
                                  circuit.out_bits)


def test_constants_match_the_cuda_source():
    """The link's fields, the base rows' alignment, the tiles and the
    block's shared memory are one on both sides: a mismatch would only
    show on the card."""
    src = (_build.CSRC / "fault_sim.cu").read_text()
    assert "fault_sim" in _build.SOURCES
    assert kernels.KERNEL_WRAPPERS["fault_lanes"] is fault_sim.fault_lanes
    assert f"constexpr int kTruthShift = {fault_sim.TRUTH_SHIFT};" in src
    assert f"constexpr size_t kSmemLimit = {fault_sim.SMEM_LIMIT};" in src
    assert f"base_stride % {fault_sim.BASE_ALIGN}" in src
    cases = [int(c) for c in re.findall(r"REPRO_CASE\((\d)\)", src)]
    assert cases == list(fault_sim.TILE_LOGS)
    assert all(fault_sim.BASE_ALIGN % (1 << t) == 0
               for t in fault_sim.TILE_LOGS)


@pytest.mark.parametrize("n_gates", [300, 60000])
def test_launch_hands_the_entry_point_its_arguments(monkeypatch, n_gates):
    """The wrapper's launch, with the library faked: as many pointers and
    ints as `repro_fault_lanes` declares, the grid and tile from the gate
    count, a scratch buffer only past shared memory; one launch counted."""
    src = (_build.CSRC / "fault_sim.cu").read_text()
    decl = re.search(r'extern "C" int repro_fault_lanes\((.*?)\)', src, re.S)
    params = [p.split()[-1] for p in decl.group(1).split(",")]
    kinds = [p.split()[0] for p in decl.group(1).replace("const ", "")
             .split(",")]
    n_ptrs = kinds.index("int")
    assert kinds[n_ptrs:-1] == ["int"] * (len(kinds) - n_ptrs - 1)
    seen = {}

    def function(lib, name, ptrs, ints):
        assert (lib, name, ptrs, ints) == (
            "fault_sim", "repro_fault_lanes", n_ptrs, len(kinds) - n_ptrs - 1)

        def call(*args):
            assert len(args) == len(params)
            seen.update(zip(params, args))
            return 0
        return call

    monkeypatch.setattr(_build, "on_cuda", lambda t, k: True)
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    circuit = _random_circuit(n_gates, seed=1, window=64)
    x8 = np.random.default_rng(0).integers(0, 256, (100, 16))
    mask, val, _ = _lanes(circuit, 0, seed=0, every=max(1, n_gates // 5))
    before = _launches()
    fault_sim.fault_lanes(_base_words(circuit, x8), _host_tables(circuit),
                          torch.as_tensor(mask), torch.as_tensor(val), 100)
    assert _launches() == before + 1
    log_t, in_smem = fault_sim.placement(n_gates)
    units = len(mask) * -(-4 // (1 << log_t))
    assert seen["n_lanes"] == len(mask) and seen["n_words"] == 4
    assert seen["base_stride"] == fault_sim.BASE_ALIGN
    assert (seen["log_t"], seen["n_gates"]) == (log_t, n_gates)
    assert seen["grid"] == min(units, fault_sim.BLOCKS_PER_SM * 132)
    assert (seen["scratch"].value is None) == in_smem


@pytest.mark.parametrize("n_gates,want", [
    (98, (2, True)), (2706, (2, True)), (8386, (2, True)),
    (14304, (2, True)), (14305, (3, False)), (34160, (3, False)),
    (539472, (3, False))])
def test_placement_follows_the_gate_count(n_gates, want):
    """4-word tiles in shared memory while their lane state fits a block's;
    8-word tiles in global scratch past that."""
    assert fault_sim.placement(n_gates) == want
    fits = 4 * fault_sim.state_words(n_gates, 2) <= fault_sim.SMEM_LIMIT
    assert fits == want[1]


def _wrapper_operands():
    circuit = _random_circuit(300, seed=4, window=64)
    x8 = np.random.default_rng(0).integers(0, 256, (40, 16))
    mask, val, _ = _lanes(circuit, 2, seed=0, every=20)
    return dict(base=_base_words(circuit, x8), tables=_host_tables(circuit),
                mask=torch.as_tensor(mask), value=torch.as_tensor(val),
                batch=x8.shape[0])


@pytest.mark.parametrize("bad,match", [
    ("mask_dtype", "mask has dtype"), ("value_width", "value has shape"),
    ("value_lanes", "value has shape"), ("base_words", "base has shape"),
    ("links_dtype", "links has dtype"), ("out_shape", "out has shape"),
    ("mask_device", "mask is on meta"), ("meta", "unsupported device"),
    ("strided", "mask must be contiguous")])
def test_wrapper_checks_its_operands(bad, match):
    ops = _wrapper_operands()
    mask, value, base = ops["mask"], ops["value"], ops["base"]
    if bad == "mask_dtype":
        ops["mask"] = mask.to(torch.uint8)
    elif bad == "value_width":
        ops["value"] = value[:, 1:].contiguous()
    elif bad == "value_lanes":
        ops["value"] = value[1:].contiguous()
    elif bad == "base_words":
        ops["batch"] += 32 * fault_sim.BASE_ALIGN
    elif bad == "links_dtype":
        ops["tables"] = ops["tables"]._replace(
            links=ops["tables"].links.long())
    elif bad == "out_shape":
        ops["out"] = torch.empty((len(mask), ops["batch"] + 1),
                                 dtype=torch.int32)
    elif bad == "mask_device":
        ops["mask"] = mask.to("meta")
    elif bad == "meta":
        ops["base"] = base.to("meta")
        ops["tables"] = fault_sim.FaultTables(
            *(t.to("meta") for t in ops["tables"][:4]), ops["tables"].n_base)
        ops["mask"], ops["value"] = mask.to("meta"), value.to("meta")
    elif bad == "strided":
        ops["mask"] = torch.cat([mask, mask], 1)[:, ::2]
    with pytest.raises(ValueError, match=match):
        fault_sim.fault_lanes(**ops)


def test_wrapper_writes_into_out_and_takes_no_lanes():
    ops = _wrapper_operands()
    want = fault_sim.fault_lanes(**ops)
    out = torch.full((len(ops["mask"]), ops["batch"]), -7, dtype=torch.int32)
    assert fault_sim.fault_lanes(**ops, out=out) is out
    assert torch.equal(out, want)
    none = fault_sim.fault_lanes(ops["base"], ops["tables"], ops["mask"][:0],
                                 ops["value"][:0], ops["batch"])
    assert none.shape == (0, ops["batch"]) and none.dtype == torch.int32


# --- the kernel on the card ---------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fault-lane kernel runs on the "
                    "card")
    return torch.device("cuda")


def _launches() -> int:
    return kernels.launched(fault_sim.fault_lanes)


def _plain_on_card(circuit, x8, mask, val, dev, step: int = 512):
    """The plain version over the card's copies of the operands, ``step``
    lanes at a time."""
    tables = _host_tables(circuit, dev)
    base = _base_words(circuit, x8, dev)
    return np.concatenate([fault_sim.fault_lanes_plain(
        base, tables, torch.as_tensor(mask[lo:lo + step], device=dev),
        torch.as_tensor(val[lo:lo + step], device=dev), len(x8)).cpu()
        .numpy() for lo in range(0, len(mask), step)])


def _card_check(circuit, x8, mask, val, faults, dev, picks):
    """The card's simulator (one launch) == the plain version on the card ==
    the serial oracle at ``picks``; returns its classes."""
    sim = t_faults.FaultSimulator(circuit, device=dev)
    before = _launches()
    got = sim.run_masks(x8, mask, val)
    assert _launches() == before + 1
    assert got.dtype == np.int32 and got.shape == (len(mask), len(x8))
    np.testing.assert_array_equal(got, _plain_on_card(circuit, x8, mask, val,
                                                      dev))
    np.testing.assert_array_equal(got[picks],
                                  _serial(circuit, x8, faults, picks))
    return got


@pytest.mark.torch_cuda
def test_card_lanes_equal_plain_and_oracle(port_case, cuda_device):
    """The four circuits: every lane on the card == the plain version == the
    CPU simulator; a spread of lanes == the serial oracle."""
    circuit, x8, mask, val, faults = port_case
    picks = np.concatenate([_spread(len(mask) - 8),
                            len(mask) - 8 + np.arange(8)])
    got = _card_check(circuit, x8, mask, val, faults, cuda_device, picks)
    np.testing.assert_array_equal(got, t_faults.FaultSimulator(
        circuit, device="cpu").run_masks(x8, mask, val))


@pytest.fixture(scope="module")
def har_tree():
    """The port's har tree over all 3,090 test rows (not a multiple of 32),
    with every single lane and 32 multi-fault lanes."""
    ds = t_load_dataset("har")
    pt = t_to_parallel(t_train_tree(ds.x_train, ds.y_train, ds.n_classes))
    t_int = np.floor(pt.threshold.astype(np.float64) * 256).astype(np.int64)
    circuit = t_netlist.build_circuit([pt], np.full(t_int.size, 8), t_int,
                                      ds.n_classes)
    x8 = t_quantize_u8(ds.x_test)
    return (circuit, x8, *_lanes(circuit, 32, seed=9))


@pytest.mark.torch_cuda
def test_card_har_tree_campaign(har_tree, cuda_device):
    """B = 3,090: every single lane and 32 multi-fault lanes in one launch
    == the plain version == the serial oracle at a spread; an explicit chunk
    splits the launches and changes nothing."""
    circuit, x8, mask, val, faults = har_tree
    assert len(x8) == 3090
    picks = np.concatenate([_spread(len(mask) - 32),
                            len(mask) - 32 + np.arange(0, 32, 4)])
    got = _card_check(circuit, x8, mask, val, faults, cuda_device, picks)
    sim = t_faults.FaultSimulator(circuit, device=cuda_device)
    before = _launches()
    np.testing.assert_array_equal(sim.run_masks(x8, mask, val, chunk=1000),
                                  got)
    assert _launches() == before + -(-len(mask) // 1000)


@pytest.mark.torch_cuda
@pytest.mark.parametrize("n_gates,log_t,in_smem", [
    (1500, 2, True), (6000, 2, True), (14304, 2, True), (14305, 3, False),
    (40000, 3, False), (60000, 3, False)])
def test_card_random_circuits_both_placements(n_gates, log_t, in_smem,
                                              cuda_device):
    """Random circuits in shared memory up to its last gate and past it in
    global scratch: the card == the plain version == the serial oracle."""
    assert fault_sim.placement(n_gates) == (log_t, in_smem)
    circuit = _random_circuit(n_gates, seed=n_gates)
    x8 = np.random.default_rng(n_gates).integers(0, 256, (1000, 16))
    mask, val, faults = _lanes(circuit, 16, seed=n_gates,
                               every=max(1, n_gates // 256))
    _card_check(circuit, x8, mask, val, faults, cuda_device,
                np.concatenate([_spread(len(mask) - 16, 6),
                                len(mask) - 16 + np.arange(0, 16, 5)]))


@pytest.mark.torch_cuda
def test_card_edge_lanes(port_case, cuda_device):
    """No lanes launch nothing; one lane (the zero-fault lane) is one launch
    and equals `netlist.simulate`; an explicit chunk that splits the lanes
    launches once a chunk and changes nothing."""
    circuit, x8, mask, val, _ = port_case
    sim = t_faults.FaultSimulator(circuit, device=cuda_device)
    before = _launches()
    none = sim.run_masks(x8, mask[:0], val[:0])
    assert none.shape == (0, len(x8)) and _launches() == before
    zero = sim.run_zero_fault(x8)
    assert _launches() == before + 1
    np.testing.assert_array_equal(zero, t_netlist.simulate(
        circuit, torch.as_tensor(x8, device=cuda_device)).cpu().numpy())
    whole = sim.run_masks(x8, mask, val)
    for chunk in (1, 7, len(mask) - 1):
        before = _launches()
        np.testing.assert_array_equal(
            sim.run_masks(x8, mask, val, chunk=chunk), whole)
        assert _launches() == before + -(-len(mask) // chunk)
