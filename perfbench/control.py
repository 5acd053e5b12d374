"""The controls and planted faults that the check of `correct` has to
fail, run through the harness with the timed path swapped underneath.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 3 --swap control

``--swap`` names what replaces the program's timed path:

  control    the plain reference in the program's place, a notch below
             what the configuration states: a search chunk run by the
             reference with its genes and objectives rounded to bfloat16
             (the configuration states float32); the fault simulator
             replaced by the reference's, on 7-bit input codes (it states
             8-bit codes);
  unchanged  a search chunk that returns its state unchanged;
  half       half of the batch left out, the mean taken over the rest:
             the search's problem and the campaign on the first half of
             their rows;
  altered    one answer altered where it is produced: the first
             objective of the chunk's first survivor moved by one ulp, or
             one row's class in the last lane of every fault-simulator
             call;
  circuit    the campaign's circuit lowered with every threshold 16
             codes too high;
  sites      the campaign over half of the circuit's fault sites.

Each seed's line gives the run's ``correct`` and its compared numbers.
The benchmark's own runs never run this file; the tests run it at a small
size on the CPU, and it runs on the card at the cells' own sizes.
"""
from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

SWAPS = ("control", "unchanged", "half", "altered", "circuit", "sites")


@contextlib.contextmanager
def swapped(kind: str, swap: str):
    """The program's timed path of traffic ``kind`` with ``swap`` in its
    place, for the duration of the block."""
    if swap not in SWAPS:
        raise ValueError(f"unknown swap {swap!r}; one of {SWAPS}")
    patches = (_search if kind == "search" else _faults)(swap)
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    try:
        for obj, name, value in patches:
            setattr(obj, name, value)
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def _search(swap: str) -> list:
    import torch

    from repro_torch.core import nsga2
    from repro_torch.families import printed_mlp
    from repro_torch.search import problem as problem_mod

    if swap == "half":
        build_tree, from_masters = (problem_mod.build_tree_problem,
                                    printed_mlp.problem_from_masters)

        def half_tree(pt, x_test, y_test, device="cuda"):
            half = len(y_test) // 2
            return build_tree(pt, x_test[:half], y_test[:half], device=device)

        def half_mlp(w1, w2, shift, n_classes, x8, y, device="cuda"):
            half = len(y) // 2
            return from_masters(w1, w2, shift, n_classes, x8[:half], y[:half],
                                device=device)

        return [(problem_mod, "build_tree_problem", half_tree),
                (printed_mlp, "problem_from_masters", half_mlp)]

    make_chunk = nsga2.make_chunk

    def swapped_chunk(fitness, cfg, length):
        chunk = make_chunk(fitness, cfg, length)

        def run(state, gen):
            if swap == "unchanged":
                return nsga2.NSGA2State(state.genes, state.objs, state.rank,
                                        state.crowd, state.generation + length)
            if swap == "control":
                return _bf16_chunk(state, gen, length, fitness)
            out = chunk(state, gen)
            objs = out.objs.clone()
            objs[0, 0] = torch.nextafter(objs[0, 0], objs[0, 0] + 1)
            return nsga2.NSGA2State(out.genes, objs, out.rank, out.crowd,
                                    out.generation)

        return run

    swapped_chunk.captures = make_chunk.captures   # the capture counter
    return [(nsga2, "make_chunk", swapped_chunk)]


def _bf16_chunk(state, gen, length: int, fitness):
    """``length`` reference generations with genes and objectives held in
    bfloat16; the children are scored by the program's fitness and then
    rounded, so only the precision differs."""
    import torch

    from perfbench.reference import search as ref
    from repro_torch.core import nsga2

    def low(t):
        return t.to(torch.bfloat16).to(torch.float32)

    s = {"genes": low(state.genes), "objs": low(state.objs),
         "rank": state.rank.long(), "crowd": state.crowd}
    p, g = s["genes"].shape
    for _ in range(length):
        s = ref.generation(s, lambda genes: low(fitness(low(genes))),
                           ref.draws(gen, p, g, s["genes"].device))
    return nsga2.NSGA2State(s["genes"], s["objs"], s["rank"].int(),
                            s["crowd"], state.generation + length)


def _faults(swap: str) -> list:
    import numpy as np

    from repro_torch.core import faults
    from repro_torch.search import robustness

    if swap == "control":
        from perfbench.reference import faults as ref

        class Reference(faults.FaultSimulator):
            """The plain reference's simulator in the program's place, on
            7-bit input codes."""

            def run_masks(self, x8, stuck_mask, stuck_val, chunk=None):
                c = self.circuit
                net = ref.Netlist(c.op, c.a, c.b, c.out_bits, self.device)
                return net.classes(np.asarray(x8) & 0xFE, stuck_mask,
                                   stuck_val)

        return [(faults, "FaultSimulator", Reference)]
    if swap == "half":
        point = robustness.point_robustness

        def half(circuit, x8, y, **kw):
            n = len(y) // 2
            return point(circuit, x8[:n], y[:n], **kw)

        return [(robustness, "point_robustness", half)]
    if swap == "altered":
        run_masks = faults.FaultSimulator.run_masks

        def altered(self, *args, **kw):
            preds = run_masks(self, *args, **kw)
            preds[-1, 0] = (preds[-1, 0] + 1) % self.circuit.n_classes
            return preds

        return [(faults.FaultSimulator, "run_masks", altered)]
    if swap == "circuit":
        from repro_torch.core import netlist

        build = netlist.build_circuit

        def shifted(ptrees, bits, t_int, n_classes, **kw):
            return build(ptrees, bits, np.minimum(np.asarray(t_int) + 16, 255),
                         n_classes, **kw)

        return [(netlist, "build_circuit", shifted)]
    if swap == "sites":
        enumerate_sites = faults.enumerate_fault_sites

        def half_sites(circuit):
            found = enumerate_sites(circuit)
            return found[:len(found) // 2]

        return [(faults, "enumerate_fault_sites", half_sites)]
    raise ValueError(f"swap {swap!r} does not apply to a fault campaign")


def run(cell: str, seeds, seconds: float, swap: str, device: str = "cuda",
        root=None) -> list:
    """One line per seed: the run's ``correct`` and compared numbers."""
    from perfbench import harness

    root = Path(root) if root else harness.ROOT
    bench = harness.benchmark(root)
    spec = harness.entry(bench["workloads"], cell, "cell")
    kind = json.loads((root / "perfbench" / "traffic"
                       / f"{spec['traffic']}.json").read_text())["kind"]
    lines = []
    for seed in seeds:
        with swapped(kind, swap):
            result = harness.run_cell(cell, seed, seconds, False,
                                      device=device, root=root)
        lines.append({"seed": seed, "swap": swap,
                      "correct": result["correct"],
                      "check": {k: v["value"]
                                for k, v in result["check"].items()}})
    return lines


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--swap", choices=SWAPS, default="control")
    args = parser.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    from perfbench import run as runner

    runner.environment()
    for line in run(args.workload, [int(s) for s in args.seeds.split(",")],
                    args.seconds, args.swap, root=root):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
