"""Quickstart on the PyTorch/CUDA port: the paper's pipeline end to end on
one dataset.

Train an exact bespoke Decision Tree (or a random forest with --trees K),
run the NSGA-II dual-approximation search through the port's engine
(`repro_torch.search.run_search`), print the pareto front, pick the best
design under a 1% accuracy-loss budget, emit its bespoke Verilog and
verify it against the gate-level netlist simulator. The counterpart of
`examples/quickstart.py`, with its flags and defaults, plus ``--device``
(default ``cuda``; ``--device cpu`` runs the kernels' plain versions):

    PYTHONPATH=src python examples/torch_quickstart.py [--dataset seeds]
    PYTHONPATH=src python examples/torch_quickstart.py --backend kernel \
        --trees 4

(The same flow is packaged as ``python -m repro_torch.search``, which
prints the same front for the same flags.) The Verilog goes to the
temporary directory (``$TMPDIR``).
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch import search
from repro_torch.core import area, netlist, rtl
from repro_torch.device import resolve_device
from repro_torch.families import get_family


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="seeds")
    ap.add_argument("--backend", default="reference",
                    choices=list(search.BACKENDS))
    ap.add_argument("--trees", type=int, default=1)
    ap.add_argument("--pop", type=int, default=64)
    ap.add_argument("--gens", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    print(f"== {args.dataset}: train exact bespoke "
          f"{'DT' if args.trees <= 1 else f'{args.trees}-tree RF'} ==")
    prob = get_family("tree").build_problem(args.dataset,
                                            n_trees=args.trees,
                                            device=device)
    print(f"comparators={prob.n_comparators} leaves={prob.n_leaves} "
          f"test_acc={prob.exact_accuracy:.6f} "
          f"area={prob.exact_area_mm2:.1f}mm^2 "
          f"power={area.power_mw(prob.exact_area_mm2):.2f}mW "
          f"device={device}")

    print(f"== NSGA-II search (backend={args.backend}, pop={args.pop}, "
          f"gens={args.gens}) ==")
    result = search.run_search(prob, backend=args.backend,
                               pop_size=args.pop, n_generations=args.gens)

    print("pareto front (acc_loss, normalized area):")
    for o in result.pareto_objs:
        print(f"  {o[0]:+.4f}  {o[1]:.3f}  "
              f"({1 / max(o[1], 1e-9):.2f}x smaller)")

    best = result.best_under_loss(0.01)
    if best is None:
        best = result.pareto_objs[0], result.pareto_genes[0]
    o, g = best
    a_mm2 = float(o[1]) * prob.exact_area_mm2
    print(f"\nselected @<=1% loss: area={a_mm2:.1f}mm^2 "
          f"({1 / o[1]:.2f}x), power={area.power_mw(a_mm2):.2f}mW "
          f"{'< 3mW: printed-battery OK' if area.power_mw(a_mm2) < 3 else ''}")

    # the effective design: decode_chromosome folds comparator truncation
    # into the returned precision and threshold, so lowering it with trunc
    # unset is the pre-truncation design
    bits, t_int, vote_cap = search.decode_chromosome(
        prob, torch.as_tensor(g, device=device))
    vote_adder = "approx" if int(vote_cap) == 1 else "exact"
    bits, t_int = bits.cpu().numpy(), t_int.cpu().numpy()
    ptrees = search.problem_ptrees(prob)
    verilog = rtl.emit_design(ptrees, bits, t_int, prob.n_classes,
                              vote_adder=vote_adder)
    out = os.path.join(tempfile.gettempdir(), f"bespoke_{args.dataset}.v")
    with open(out, "w") as f:
        f.write(verilog)
    print(f"bespoke RTL written to {out} ({len(verilog.splitlines())} lines)")

    # the hardware oracle: gate-level netlist simulation vs the tensor
    # program
    circuit = netlist.build_circuit(ptrees, bits, t_int, prob.n_classes,
                                    vote_adder=vote_adder)
    sim = netlist.simulate(circuit, prob.x8).cpu().numpy()
    ref = search.predict_votes(prob, torch.as_tensor(bits, device=device),
                               torch.as_tensor(t_int, device=device),
                               vote_cap).cpu().numpy()
    if not np.array_equal(sim, ref):
        raise SystemExit("netlist simulation diverged from the tensor "
                         "program")
    counts = netlist.gate_counts(circuit)
    print(f"netlist verified on {sim.shape[0]} samples: "
          f"{circuit.n_gates} gates {counts}, "
          f"actual area {netlist.netlist_area_mm2(circuit):.1f}mm^2 "
          f"vs LUT estimate {a_mm2:.1f}mm^2")


if __name__ == "__main__":
    main()
