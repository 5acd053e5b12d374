"""The benchmark's plain reference against the port on the CPU at small
sizes: the same inputs, trees, masters, tables, objectives, sorts,
generations and fault campaigns, value for value."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.reference import area, cart, data, mlp
from perfbench.reference import faults as ref_faults
from perfbench.reference import search as ref

SMALL = ("seeds", "vertebral", "balance", "mammographic")


@pytest.fixture(scope="module")
def seeds_tree():
    ds = data.load("seeds")
    tree = cart.train_tree(ds["x_train"], ds["y_train"], ds["n_classes"])
    return ds, tree, cart.comparator_form(tree)


@pytest.mark.parametrize("name", SMALL)
def test_dataset_equals_the_port(name):
    from repro_torch.datasets import load_dataset

    mine, port = data.load(name), load_dataset(name)
    for k in ("x_train", "y_train", "x_test", "y_test"):
        assert np.array_equal(mine[k], getattr(port, k))


@pytest.mark.parametrize("name", SMALL)
def test_cart_equals_the_port(name):
    from repro_torch.core.train import train_tree
    from repro_torch.core.tree import to_parallel

    ds = data.load(name)
    mine = cart.train_tree(ds["x_train"], ds["y_train"], ds["n_classes"])
    port = train_tree(ds["x_train"], ds["y_train"], ds["n_classes"])
    for k in ("feature", "threshold", "left", "right", "leaf_class"):
        assert np.array_equal(mine[k], getattr(port, k))
    form, pt = cart.comparator_form(mine), to_parallel(port)
    for k in ("feature", "threshold", "path", "path_len", "n_neg",
              "leaf_class"):
        assert np.array_equal(form[k], getattr(pt, k))


def test_capped_cart_grows_best_first():
    """A cap grows the tree best first to that many leaves; a cap the tree
    never reaches classifies every row as the depth-first tree does."""
    ds = data.load("pendigits")
    full = cart.train_tree(ds["x_train"], ds["y_train"], ds["n_classes"])
    x8 = data.quantize_u8(ds["x_test"])
    for cap in (2, 20, 179):
        tree = cart.train_tree(ds["x_train"], ds["y_train"], ds["n_classes"],
                               max_leaf_nodes=cap)
        assert (tree["feature"] < 0).sum() == cap
        assert cart.comparator_form(tree)["feature"].size == cap - 1
    stump = cart.train_tree(ds["x_train"], ds["y_train"], ds["n_classes"],
                            max_leaf_nodes=2)
    assert stump["feature"][0] == full["feature"][0]
    assert stump["threshold"][0] == full["threshold"][0]
    uncapped = cart.train_tree(ds["x_train"], ds["y_train"], ds["n_classes"],
                               max_leaf_nodes=10 ** 6)
    assert np.array_equal(cart.descend(uncapped, x8)[0],
                          cart.descend(full, x8)[0])
    assert (uncapped["feature"] < 0).sum() == (full["feature"] < 0).sum()


def test_area_tables_equal_the_port():
    from repro_torch.core import area as port_area

    lut, offsets = port_area.build_area_unit_lut()
    table = area.comparator_table()
    for p in range(9):
        assert np.array_equal(table[p, :1 << p],
                              lut[offsets[p]:offsets[p] + (1 << p)])
    for w in range(-8, 8):
        assert area.mac_units(w, 8) == port_area.mac_area_units(w, 8)


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 8])
def test_snap_table_equals_the_port(bits):
    from repro_torch.quantize.bespoke import snap_lut

    for margin in range(6):
        assert np.array_equal(mlp.snap_table(bits, margin),
                              snap_lut(bits, margin))


def test_mlp_masters_and_tables_equal_the_port():
    """The port quantises the reference's trained weights to the same master
    codes and decodes them to the same tables."""
    from repro_torch.families import printed_mlp as pm

    ds = data.load("seeds")
    w1, w2 = mlp.train_masters(ds["x_train"], ds["y_train"], 3, 4, 20, 0.5, 0)
    f1, f2 = mlp.train_float(ds["x_train"], ds["y_train"], 3, 4, 20, 0.5, 0)
    assert np.array_equal(w1, pm.quantize_master(f1))
    assert np.array_equal(w2, pm.quantize_master(f2))
    shift = mlp.shift_for(*w1.shape)
    assert shift == pm.pick_shift(*w1.shape)
    for mine, port in zip(mlp.decode_tables(w1, w2, shift),
                          pm.combo_tables(w1, w2, shift)):
        assert np.array_equal(mine, port)


@pytest.mark.parametrize("name", ["seeds", "pendigits"])
def test_mlp_masters_learn(name):
    """The trainer's zero-sum hidden weights keep the bias-free layer alive:
    the exact integer design beats chance by far on the test split."""
    ds = data.load(name)
    c = ds["n_classes"]
    w1, w2 = mlp.train_masters(ds["x_train"], ds["y_train"], c, 16, 300,
                               0.5, 0)
    x8 = data.quantize_u8(ds["x_test"]).astype(np.int64)
    hidden = np.maximum(x8 @ w1, 0) >> mlp.shift_for(*w1.shape)
    accuracy = ((hidden @ w2).argmax(1) == ds["y_test"]).mean()
    assert accuracy > 2.5 / c


def _genes(n: int, p: int, seed: int) -> torch.Tensor:
    return torch.rand((p, n), generator=torch.Generator().manual_seed(seed))


def test_tree_objectives_equal_the_port(seeds_tree):
    from repro_torch.core.tree import ParallelTree
    from repro_torch.search.problem import build_tree_problem, objectives

    ds, tree, form = seeds_tree
    pt = ParallelTree(**{k: form[k] for k in (
        "feature", "threshold", "path", "path_len", "n_neg", "leaf_class")},
        n_classes=3)
    problem = build_tree_problem(pt, ds["x_test"], ds["y_test"], device="cpu")
    mine = ref.TreeObjectives(tree, form, data.quantize_u8(ds["x_test"]),
                              ds["y_test"], "cpu")
    genes = _genes(problem.n_genes, 64, 1)
    genes[0] = torch.as_tensor(problem.exact_genes())
    assert torch.equal(mine(genes), objectives(problem, genes))
    assert mine(genes)[0].tolist() == [0.0, 1.0]


def test_mlp_objectives_equal_the_port():
    from repro_torch.families import printed_mlp as pm

    ds = data.load("seeds")
    w1, w2 = mlp.train_masters(ds["x_train"], ds["y_train"], 3, 4, 20, 0.5, 0)
    x8 = data.quantize_u8(ds["x_test"])
    problem = pm.problem_from_masters(w1, w2, pm.pick_shift(*w1.shape), 3,
                                      x8, ds["y_test"], device="cpu")
    mine = ref.MLPObjectives(w1, w2, x8, ds["y_test"], "cpu")
    genes = _genes(problem.n_genes, 32, 2)
    assert torch.equal(mine(genes), pm.population_objectives(problem, genes))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort_and_crowding_equal_the_port(seed):
    from repro_torch.core import nsga2

    gen = torch.Generator().manual_seed(seed)
    objs = torch.randint(0, 6, (96, 2), generator=gen).float() / 5
    objs[::7] = objs[3]                                   # duplicates
    rank = ref.fronts(objs)
    assert torch.equal(rank, nsga2.non_dominated_sort(objs).long())
    assert torch.equal(ref.crowding(objs, rank),
                       nsga2.crowding_distance(objs, rank.int()))


def test_followed_chunk_equals_the_port(seeds_tree):
    from repro_torch.core import nsga2
    from repro_torch.core.tree import ParallelTree
    from repro_torch.search.backends import make_reference_fitness
    from repro_torch.search.problem import build_tree_problem

    ds, tree, form = seeds_tree
    pt = ParallelTree(**{k: form[k] for k in (
        "feature", "threshold", "path", "path_len", "n_neg", "leaf_class")},
        n_classes=3)
    problem = build_tree_problem(pt, ds["x_test"], ds["y_test"], device="cpu")
    fitness = make_reference_fitness(problem)
    cfg = nsga2.NSGA2Config(pop_size=12)
    gen = torch.Generator().manual_seed(5)
    draws = nsga2.draw_init(gen, 12, problem.n_genes, 1, "cpu")
    state = nsga2.init_state(fitness, cfg, draws,
                             seed_genes=problem.exact_genes())
    before = gen.get_state()
    out = nsga2.make_chunk(fitness, cfg, 4)(state, gen)
    objectives = ref.TreeObjectives(tree, form, data.quantize_u8(ds["x_test"]),
                                    ds["y_test"], "cpu")
    start = {"genes": state.genes, "objs": state.objs, "rank": state.rank,
             "crowd": state.crowd}
    followed = ref.follow(start, before, 4, objectives, "cpu")
    for k in ("genes", "objs", "crowd"):
        assert torch.equal(followed[k], getattr(out, k))
    assert torch.equal(followed["rank"], out.rank.long())


def test_fault_campaign_equals_the_port(seeds_tree):
    from repro_torch.core import faults, netlist
    from repro_torch.core.tree import ParallelTree
    from repro_torch.search import robustness

    ds, tree, form = seeds_tree
    pt = ParallelTree(**{k: form[k] for k in (
        "feature", "threshold", "path", "path_len", "n_neg", "leaf_class")},
        n_classes=3)
    t_int = np.floor(form["threshold"].astype(np.float64) * 256).astype(int)
    circuit = netlist.build_circuit(pt, np.full(t_int.size, 8), t_int, 3)
    x8 = data.quantize_u8(ds["x_test"])
    y = ds["y_test"].astype(np.int64)
    port = robustness.point_robustness(circuit, x8, y, seed=11, device="cpu")
    net = ref_faults.Netlist(circuit.op, circuit.a, circuit.b,
                             circuit.out_bits, "cpu", budget=1 << 20)
    mine = ref_faults.campaign(net, x8, y, rate=0.02, n_trials=32, seed=11)
    assert mine["n_sites"] == port["n_sites"]
    assert mine["baseline_accuracy"] == port["baseline_accuracy"]
    assert mine["single_fault"] == port["single_fault"]
    assert mine["monte_carlo"] == port["monte_carlo"]
    assert mine["critical_gates"] == [
        (c["gate"], c["drop"], c["stuck_value"]) for c in port["critical_gates"]]
    want, _ = cart.descend(tree, x8)
    assert np.array_equal(netlist.simulate(circuit, x8).numpy(), want)
    assert np.array_equal(mine["classes"]["zero"][0], want)
    sim = faults.FaultSimulator(circuit, device="cpu")
    gates, values = faults.single_fault_lanes(circuit)
    assert np.array_equal(sim.run_sites(x8, gates, values),
                          mine["classes"]["single"])
    hit, pol = robustness.draw_defects(mine["n_sites"], seed=11)
    mask = np.zeros((32, circuit.n_gates), bool)
    sites = ref_faults.sites(circuit.op)
    val = np.zeros_like(mask)
    mask[:, sites], val[:, sites] = hit, hit & pol
    assert np.array_equal(sim.run_masks(x8, mask, val),
                          mine["classes"]["trials"])
