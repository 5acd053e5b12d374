"""The port's spans and counters (`repro_torch.runtime.trace`) on the CPU:
a span enters `record_function` only under a recording profiler, and
only then keeps its interval for `trace.recorded`; the engine's and the
fault campaign's spans nest as they should; the evaluation, draw and
campaign counters, and a fitness launch's path multiply-adds, equal what
the shapes give; and what a graph capture counts, the kernels' launches
among it, is taken back and added again at every replay
(`runtime.graphs.record`, with a fake graph: capture needs a card). Three
tests are marked for the card: the simulator handed codes that are
already there, a campaign on the card (one kernel launch a `run_masks`
call, no graph), and ``fitness.path_macs`` at a forest's fitness launches
and chunk replays. Imports no JAX."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import kernels
from repro_torch.core import netlist, nsga2
from repro_torch.core import faults as t_faults
from repro_torch.core.train import train_tree
from repro_torch.core.tree import to_parallel
from repro_torch.datasets import load_dataset, quantize_u8
from repro_torch.families import get_family
from repro_torch.kernels import fitness as t_fit
from repro_torch.kernels import ops as kops
from repro_torch.runtime import graphs, trace
from repro_torch.search import backends, robustness

POP, LENGTH = 8, 3
N_VECTORS, TRIALS, CHUNK = 32, 4, 7


@pytest.fixture(scope="module")
def seeds_problem():
    return get_family("tree").build_problem("seeds", device="cpu")


def _state(problem, fitness, seed=0):
    gen = torch.Generator().manual_seed(seed)
    draws = nsga2.draw_init(gen, POP, problem.n_genes, 0, "cpu")
    return nsga2.init_state(fitness, nsga2.NSGA2Config(pop_size=POP),
                            draws), gen


def _delta(before):
    now = trace.counters()
    return {k: n - before.get(k, 0) for k, n in now.items()
            if n != before.get(k, 0)}


def _spans(prof):
    """(start_ns, end_ns, name) of the profiler's user annotations, in
    order of start."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.is_user_annotation())


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_span_enters_record_function_only_under_a_profiler(monkeypatch):
    entered = []

    def record_function(name):
        entered.append(name)
        return torch.autograd.profiler.record_function(name)

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    trace.forget()
    with trace.span("nsga2.chunk"):
        pass
    assert entered == []
    assert trace.span("faults.lanes") is trace.span("nsga2.chunk")
    assert trace.recorded()["spans"] == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("nsga2.chunk"):
            with trace.span("nsga2.chunk.draw"):
                torch.ones(2).add_(1)
    assert entered == ["nsga2.chunk", "nsga2.chunk.draw"]
    (s0, e0, outer), (s1, e1, inner) = _spans(prof)
    assert (outer, inner) == ("nsga2.chunk", "nsga2.chunk.draw")
    assert s0 <= s1 and e1 <= e0
    (n1, a1, b1), (n0, a0, b0) = trace.recorded()["spans"]
    assert (n0, n1) == ("nsga2.chunk", "nsga2.chunk.draw")
    assert a0 <= a1 <= b1 <= b0
    trace.forget()
    assert trace.recorded() == {"spans": [], "counts": {}}


def test_counters_add_copy_and_are_recorded_under_a_profiler():
    trace.forget()
    before = trace.counters()
    trace.count("test.counter", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        trace.count("test.counter")
    got = trace.counters()
    got["test.counter"] += 100           # a copy: the registry is unmoved
    assert _delta(before) == {"test.counter": 4}
    assert trace.recorded()["counts"] == {"test.counter": 1}
    trace.forget()


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_fitness_counts_the_rows_it_scores(seeds_problem, backend):
    fitness = backends.make_fitness(seeds_problem, backend)
    genes = torch.rand((5, seeds_problem.n_genes),
                       generator=torch.Generator().manual_seed(0))
    before = trace.counters()
    fitness(genes)
    assert _delta(before) == {"nsga2.evaluations": 5}


def test_cpu_chunk_counts_its_evaluations_and_is_one_span(seeds_problem):
    fitness = backends.make_fitness(seeds_problem, "reference")
    before = trace.counters()
    state, gen = _state(seeds_problem, fitness)
    assert _delta(before) == {"nsga2.evaluations": POP}
    chunk = nsga2.make_chunk(fitness, nsga2.NSGA2Config(pop_size=POP),
                             LENGTH)
    draws = len(dataclasses.fields(nsga2.StepDraws))
    before = trace.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            state = chunk(state, gen)
    assert _delta(before) == {"nsga2.evaluations": 2 * POP * LENGTH,
                              "nsga2.draws": 2 * LENGTH * draws}
    assert [n for _, _, n in _spans(prof)] == ["nsga2.chunk"] * 2
    assert state.generation == 2 * LENGTH


def test_capture_counts_are_rewound_and_added_at_each_replay():
    before = trace.counters()
    launches = kernels.launch_counts()

    def body():
        trace.count("test.captured", 3)
        trace.count("launches.fitness_correct_counts", 2)
        return "out"

    fake = _FakeGraph()
    graph, out = graphs.record(fake, body)
    assert out == "out"
    assert _delta(before) == {"graphs.captures": 1}
    assert kernels.launch_counts() == launches
    for _ in range(2):
        graph.replay()
    assert fake.replays == 2
    assert _delta(before) == {"graphs.captures": 1, "test.captured": 6,
                              "launches.fitness_correct_counts": 4}
    assert (kernels.launch_counts()["fitness_errors"]
            == launches["fitness_errors"] + 4)
    assert (kernels.launched(t_fit.fitness_correct_counts)
            == launches["fitness_errors"] + 4)


def test_reset_clears_the_launch_counters_alone():
    trace.count("launches.fitness_correct_counts", 2)
    trace.count("launches.qmatmul.float", 1)
    before = trace.counters()
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}
    assert (trace.counters()["launches.qmatmul.float"]
            == before["launches.qmatmul.float"])


def test_graph_chunk_replay_adds_its_evaluations(monkeypatch, seeds_problem):
    """`_GraphChunk` over a fake capture: the captured steps' evaluations
    are not counted at capture, P x chunk_len are at each call, and a
    call's phases are four spans, one after another."""
    fakes = []

    def fake_capture(warmup, body, device):
        fakes.append(_FakeGraph())
        return graphs.record(fakes[-1], body)

    monkeypatch.setattr(nsga2.graphs, "capture", fake_capture)
    fitness = backends.make_fitness(seeds_problem, "reference")
    state, gen = _state(seeds_problem, fitness, 1)
    step = nsga2.make_step(fitness, nsga2.NSGA2Config(pop_size=POP))
    before, captures = trace.counters(), nsga2.make_chunk.captures
    chunk = nsga2._GraphChunk(step, LENGTH, state)
    assert _delta(before) == {"graphs.captures": 1}
    assert nsga2.make_chunk.captures == captures + 1
    before = trace.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            out = chunk.run(state, gen)
    assert fakes[0].replays == 2
    assert _delta(before)["nsga2.evaluations"] == 2 * POP * LENGTH
    assert out.generation == state.generation + LENGTH
    phases = ["nsga2.chunk.draw", "nsga2.chunk.load", "nsga2.chunk.replay",
              "nsga2.chunk.unload"]
    marks = _spans(prof)
    assert [n for _, _, n in marks] == phases * 2
    assert all(a[1] <= b[0] for a, b in zip(marks, marks[1:]))


def _plain_span_columns(path: np.ndarray) -> int:
    """The comparator columns a padded path's leaf tiles run over: each
    tile of 32 rows from the 32-aligned start of its first nonzero column
    to the 32-aligned end of its last, 32 where it has none."""
    total = 0
    for rows in path.reshape(-1, t_fit.LEAF_TILE, path.shape[1]):
        cols = np.flatnonzero(rows.any(0))
        total += (cols[-1] // 32 + 1 - cols[0] // 32) * 32 if cols.size else 32
    return total


def _fitness_operands(problem):
    return kops.prepare_fitness_operands(
        problem.x_sel, problem.y, problem.path, problem.path_len,
        problem.n_neg, problem.leaf_class, problem.n_classes)


@pytest.mark.parametrize("dataset", ["seeds", "vertebral"])
@pytest.mark.parametrize("n_trees", [1, 3, 5])
def test_path_macs_equal_a_plain_count_over_the_padded_path(n_trees, dataset):
    """`FitnessOperands.path_macs`, what a launch adds to
    ``fitness.path_macs``: P x B x 32 x the plain count of its tiles'
    columns, each stacked problem's summed; the CPU's plain version
    counts nothing."""
    problem = get_family("tree").build_problem(dataset, n_trees=n_trees,
                                               device="cpu")
    ops = _fitness_operands(problem)
    columns = _plain_span_columns(ops.path.numpy())
    assert ops.span_columns == columns
    assert ops.path_macs(7, 50) == 7 * 50 * t_fit.LEAF_TILE * columns
    stacked = t_fit.stack_operands([ops, ops])
    assert stacked.path_macs(7, 50) == 2 * ops.path_macs(7, 50)
    assert stacked.member(1).path_macs(7, 50) == ops.path_macs(7, 50)
    genes = torch.rand((4, problem.n_genes),
                       generator=torch.Generator().manual_seed(n_trees))
    shift, thr, _, cap = kops.decode_population_full(problem.threshold, genes)
    before = trace.counters()
    t_fit.fitness_correct_counts(ops, shift, thr, cap)
    assert _delta(before) == {}


@pytest.fixture(scope="module")
def seeds_circuit():
    ds = load_dataset("seeds")
    pt = to_parallel(train_tree(ds.x_train, ds.y_train, ds.n_classes))
    t_int = np.floor(pt.threshold.astype(np.float64) * 256).astype(np.int64)
    circuit = netlist.build_circuit([pt], np.full(t_int.size, 8), t_int,
                                    ds.n_classes)
    return (circuit, quantize_u8(ds.x_test)[:N_VECTORS],
            np.asarray(ds.y_test[:N_VECTORS], np.int64))


def _tables(sim):
    tables = [sim._order, sim._feat, sim._bit, sim._base_ops, sim._out_rows,
              sim._out_shift, sim._bit_shift]
    return sum(t.nbytes for t in tables
               + [t for level in sim._levels for t in level[2:]])


def test_simulator_counts_its_tables(seeds_circuit):
    circuit, _, _ = seeds_circuit
    before = trace.counters()
    sim = t_faults.FaultSimulator(circuit, device="cpu")
    assert _delta(before) == {"faults.upload_bytes": _tables(sim)}


def test_campaign_counts_equal_its_shapes(seeds_circuit):
    circuit, x8, y = seeds_circuit
    before = trace.counters()
    t_faults.FaultSimulator(circuit, device="cpu")
    tables = _delta(before)["faults.upload_bytes"]
    before = trace.counters()
    report = robustness.point_robustness(circuit, x8, y, n_trials=TRIALS,
                                         chunk=CHUNK, device="cpu")
    lanes = 1 + 2 * report["n_sites"] + TRIALS
    assert _delta(before) == {
        "faults.lanes": lanes,
        # the index tables, every lane's mask and values, the codes handed
        # to the simulator three times and to the oracle once
        "faults.upload_bytes": (tables + 2 * lanes * circuit.n_gates
                                + 4 * x8.nbytes),
        # every lane's int32 classes and the oracle's
        "faults.readback_bytes": 4 * lanes * N_VECTORS + 4 * N_VECTORS,
    }


def test_campaign_spans_nest_under_it(seeds_circuit):
    circuit, x8, y = seeds_circuit
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        robustness.point_robustness(circuit, x8, y, n_trials=TRIALS,
                                    chunk=CHUNK, device="cpu")
    marks = _spans(prof)
    (start, end, first), rest = marks[0], marks[1:]
    assert first == "faults.campaign"
    assert all(start <= s and e <= end for s, e, _ in rest)
    names = [n for _, _, n in rest]
    per_run = ["faults.upload", "faults.capture", "faults.lanes",
               "faults.readback"]
    assert names == (
        ["faults.simulator", *per_run, "faults.oracle", "faults.reduce",
         "faults.masks", "faults.masks", *per_run, "faults.reduce",
         "faults.draws", "faults.masks", *per_run, "faults.reduce",
         "faults.reduce"])
    assert all(a[1] <= b[0] for a, b in zip(rest, rest[1:]))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the simulator's kernel runs on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.torch_cuda
def test_codes_on_the_card_are_no_upload(seeds_circuit, cuda_device):
    """Codes already on the simulator's device are handed over without a
    copy, and count nothing in ``faults.upload_bytes``; host codes count
    their bytes."""
    circuit, x8, _ = seeds_circuit
    sim = t_faults.FaultSimulator(circuit, device="cuda")
    on_card = torch.as_tensor(x8, device=cuda_device)
    masks = np.zeros((3, circuit.n_gates), bool)
    want = sim.run_masks(x8, masks, masks)
    before = trace.counters()
    got = sim.run_masks(on_card, masks, masks)
    np.testing.assert_array_equal(got, want)
    assert _delta(before)["faults.upload_bytes"] == 2 * masks.nbytes
    before = trace.counters()
    sim.run_masks(x8, masks, masks)
    assert (_delta(before)["faults.upload_bytes"]
            == 2 * masks.nbytes + x8.nbytes)


@pytest.mark.torch_cuda
def test_card_campaign_spans_and_counts(seeds_circuit, cuda_device):
    """A campaign on the card: each `run_masks` call is its upload, one
    launch of the fault-lane kernel and its readback; no span
    ``faults.capture``, no graph captured; the bytes as on the CPU, with
    the card's tables."""
    circuit, x8, y = seeds_circuit
    before = trace.counters()
    t_faults.FaultSimulator(circuit, device="cuda")
    tables = _delta(before)["faults.upload_bytes"]
    robustness.point_robustness(circuit, x8, y, n_trials=TRIALS,
                                device="cuda")   # every shape built once
    before = trace.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        report = robustness.point_robustness(circuit, x8, y,
                                             n_trials=TRIALS, device="cuda")
    lanes = 1 + 2 * report["n_sites"] + TRIALS
    assert _delta(before) == {
        "faults.lanes": lanes,
        "faults.upload_bytes": (tables + 2 * lanes * circuit.n_gates
                                + 4 * x8.nbytes),
        "faults.readback_bytes": 4 * lanes * N_VECTORS + 4 * N_VECTORS,
        "launches.fault_lanes": 3,
    }
    per_run = ["faults.upload", "faults.lanes", "faults.readback"]
    names = [n for _, _, n in _spans(prof)]
    assert names == (
        ["faults.campaign", "faults.simulator", *per_run, "faults.oracle",
         "faults.reduce", "faults.masks", "faults.masks", *per_run,
         "faults.reduce", "faults.draws", "faults.masks", *per_run,
         "faults.reduce", "faults.reduce"])


@pytest.mark.torch_cuda
def test_card_fitness_counts_path_macs_at_launches_and_replays(cuda_device):
    """On the card each fitness launch adds its path product's
    multiply-adds to ``fitness.path_macs``, and a captured chunk adds its
    generations' at each replay, not at its capture."""
    problem = get_family("tree").build_problem("seeds", n_trees=3,
                                               device=cuda_device)
    per_launch = _fitness_operands(problem).path_macs(POP, problem.y.shape[0])
    fitness = backends.make_fitness(problem, "kernel")
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    draws = nsga2.draw_init(gen, POP, problem.n_genes, 0, cuda_device)
    cfg = nsga2.NSGA2Config(pop_size=POP)
    before = trace.counters()
    state = nsga2.init_state(fitness, cfg, draws)
    got = _delta(before)
    assert got["fitness.path_macs"] == per_launch
    assert got["launches.fitness_correct_counts"] == 1
    chunk = nsga2.make_chunk(fitness, cfg, LENGTH)
    state = chunk(state, gen)                         # captures the graph
    before = trace.counters()
    for _ in range(2):
        state = chunk(state, gen)
    torch.cuda.synchronize(cuda_device)
    got = _delta(before)
    assert got["fitness.path_macs"] == 2 * LENGTH * per_launch
    assert got["launches.fitness_correct_counts"] == 2 * LENGTH
    assert got["nsga2.evaluations"] == 2 * LENGTH * POP
