"""Traffic of kind "faults": stuck-at campaigns on the exact design's
circuit, back to back, closed loop.

Set-up grows nothing new: the configuration's family lowers the exact
design through the port (for a tree, every comparator at 8 bits against
its trained threshold, by `core.netlist.build_circuit`); the campaign's
rows are the test split drawn with replacement from the seed, as many as
the split holds; every shape a campaign uses is warmed: the simulator's
zero-fault lane, two chunks of single-fault lanes at the campaign's
chunk, `netlist.simulate`. The window runs
`repro_torch.search.robustness.point_robustness` on that circuit and
those rows, one campaign after another, each with its own Monte-Carlo
seed drawn from the run's seed, until the host clock passes ``--seconds``
after a campaign. A campaign's lanes are the zero-fault lane, both stuck
values of every site and the Monte-Carlo trials.

The campaign hands its simulator's classes to the host, every row of
every lane, and reduces them there; the window keeps a reference to those
arrays (a subclass of the port's `FaultSimulator` that records what
``run_masks`` returns, nothing else). The check judges the window's last
campaign, element by element: the zero-fault lane's class of every row
against the family's plain oracle of the exact design (for a tree, its
descent, which owes nothing to the lowering); every single-fault lane's
and every trial's class of every row against the plain reference's own
simulation of the circuit, with its own sites and its own defect draws;
then the report's counts, figures and critical gates against the
reference's.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench import tracing
from perfbench.reference import data
from perfbench.reference import faults as ref


def _mc_seed(seed: int, campaign: int) -> int:
    return int(np.random.SeedSequence([seed, campaign]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def rows_wrong(have, want: np.ndarray) -> int:
    """Elements where the program's (lanes, rows) classes differ from the
    reference's; every element of the larger shape where the shapes do."""
    if have is None or np.shape(have) != want.shape:
        shape = np.maximum(np.shape(have) if have is not None else (0, 0),
                           want.shape)
        return int(np.prod(shape))
    return int((np.asarray(have) != want).sum())


def measure(ctx):
    import torch

    from repro_torch.core import faults, netlist
    from repro_torch.search import robustness

    t = ctx.traffic
    n_test = ctx.inputs["y_test"].shape[0]
    rows = np.random.default_rng(np.random.SeedSequence([ctx.seed, 0])).integers(
        0, n_test, n_test)
    x8 = data.quantize_u8(ctx.inputs["x_test"][rows])
    y = ctx.inputs["y_test"][rows].astype(np.int64)
    circuit = ctx.family.exact_circuit(ctx)
    sim = faults.FaultSimulator(circuit, device=ctx.device)
    sim.run_zero_fault(x8)
    gates, values = faults.single_fault_lanes(circuit)
    per = t["chunk"] or faults.packed_chunk(circuit, n_test)
    sim.run_sites(x8, gates[:2 * per], values[:2 * per], chunk=t["chunk"])
    netlist.simulate(circuit, torch.as_tensor(x8, device=ctx.device))
    del sim
    ctx.sync()
    setup_s = time.time() - ctx.t_start

    lanes = 2 * ref.sites(circuit.op).size + t["n_trials"] + 1
    outputs = []                 # the simulator's classes, call by call

    base = faults.FaultSimulator

    class Recording(base):
        def run_masks(self, *args, **kw):
            classes = super().run_masks(*args, **kw)
            outputs.append(classes)
            return classes

    def campaign(i):
        outputs.clear()
        return robustness.point_robustness(
            circuit, x8, y, defect_rate=t["defect_rate"],
            n_trials=t["n_trials"], seed=_mc_seed(ctx.seed, i),
            top_k=t["top_k"], chunk=t["chunk"], device=ctx.device)

    done = 0
    faults.FaultSimulator = Recording
    try:
        t0 = time.perf_counter()
        while True:
            last = campaign(done)
            done += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        ctx.sync()
        window_s = time.perf_counter() - t0
    finally:
        faults.FaultSimulator = base
    judged_seed = _mc_seed(ctx.seed, done - 1)
    judged = list(outputs) + [None] * (3 - len(outputs))
    record = {"kind": "faults", "setup_s": setup_s, "window_s": window_s,
              "lanes": done * lanes, "attempted": done * lanes, "failed": 0,
              "trace": None}
    if ctx.trace:
        record.update(traced_lanes=lanes,
                      trace=tracing.profile(lambda: campaign(done)))
    gate_arrays = (circuit.op, circuit.a, circuit.b, circuit.out_bits)
    del circuit

    def judge():
        net = ref.Netlist(*gate_arrays, ctx.device)
        got = ref.campaign(net, x8, y, rate=t["defect_rate"],
                           n_trials=t["n_trials"], seed=judged_seed,
                           top_k=t["top_k"])
        want = got["classes"]
        zero, single, trials = judged[:3]
        oracle = ctx.family.exact_classes(ctx, x8)[None, :]
        critical = [(c["gate"], c["drop"], c["stuck_value"])
                    for c in last["critical_gates"]]
        report_gap = max(
            [abs(last["baseline_accuracy"] - got["baseline_accuracy"])]
            + [abs(last[k][f] - got[k][f])
               for k in ("single_fault", "monte_carlo") for f in got[k]])
        return [
            ("zero_rows_wrong", float(rows_wrong(zero, oracle)), 0.0),
            ("single_rows_wrong", float(rows_wrong(single, want["single"])),
             0.0),
            ("trial_rows_wrong", float(rows_wrong(trials, want["trials"])),
             0.0),
            ("lanes_gap", float(abs(last["n_faults"] - 2 * got["n_sites"])
                                + abs(last["n_sites"] - got["n_sites"])), 0.0),
            ("report_gap", report_gap, 0.0),
            ("critical_mismatch", float(
                sum(a != b for a, b in zip(critical, got["critical_gates"]))
                + abs(len(critical) - len(got["critical_gates"]))), 0.0),
        ]

    return record, judge
