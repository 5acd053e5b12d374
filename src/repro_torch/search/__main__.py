"""CLI of the port's search engine.

    PYTHONPATH=src python -m repro_torch.search --dataset seeds \
        --backend kernel --pop 64 --gens 40 --out runs/seeds [--device cuda]
    PYTHONPATH=src python -m repro_torch.search --dataset seeds --trees 4 \
        --backend kernel --checkpoint-every 10 --out runs/seeds_forest \
        [--resume]
    PYTHONPATH=src python -m repro_torch.search --family mlp --hidden 16 \
        --dataset seeds --backend kernel --out runs/seeds_mlp
    PYTHONPATH=src python -m repro_torch.search serve \
        --pareto runs/seeds/pareto.json [--verify-netlist] [--device cuda]

The run command trains the exact design (a bespoke tree, with `--trees K` a
bootstrap forest, or with `--family mlp` a printed integer-weight MLP), runs
the NSGA-II search (with `--checkpoint-every N --out D`, saving every N
generations under D/ckpt; `--resume` continues from the newest save) on
the selected backend, prints the pareto front and the best design under the
accuracy-loss budget, and with --out writes pareto.json plus the Verilog of
the selected design (`--emit-rtl`: every point's; `--verify-rtl`: simulate
every point's netlist and require it to equal the tensor program and the
kernel). `serve` serves a pareto.json point over its dataset's test split
and requires the served accuracy to reproduce the recorded one. Both take
``--device`` (default cuda; cpu runs the plain versions of the kernels).
What the port does not cover yet exits with status 2 and names the
ROADMAP.md queue item that will port it.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.core import area
from repro_torch.datasets import DATASET_SPECS, load_dataset

# Surfaces of `python -m repro.search` this slice does not port yet, and the
# ROADMAP.md item that will.
NOT_PORTED = {
    "islands": "--backend islands: ROADMAP.md Queue 1 item 12",
    "mesh": "--mesh (multi-device search): ROADMAP.md Queue 1 item 12",
    "sweep": "the sweep subcommand: ROADMAP.md Queue 1 item 9",
    "faults": "the faults subcommand: ROADMAP.md Queue 1 item 11",
}


def _not_ported(what: str) -> None:
    print(f"error: not ported yet: {NOT_PORTED[what]}", file=sys.stderr)
    raise SystemExit(2)


def _device_or_exit(device: str):
    """The torch device for ``--device``, or exit(2) with a one-line error
    when it names an absent GPU."""
    from repro_torch.device import CudaUnavailableError, resolve_device

    try:
        return resolve_device(device)
    except CudaUnavailableError as e:
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2)


def _load_artifact_or_exit(path: str):
    """Load a pareto.json, or exit(2) with a one-line error."""
    from repro_torch.search import load_pareto_artifact

    try:
        return load_pareto_artifact(path)
    except (OSError, ValueError) as e:
        msg = str(e).strip() or type(e).__name__
        print(f"error: pareto artifact {path}: {type(e).__name__}: {msg}",
              file=sys.stderr)
        raise SystemExit(2)


def serve_main(argv=None) -> None:
    """`python -m repro_torch.search serve`: serve a pareto.json design."""
    import time

    from repro_torch.core import netlist
    from repro_torch.runtime.classify import BACKENDS as SERVE_BACKENDS
    from repro_torch.runtime.classify import ClassifyServer

    ap = argparse.ArgumentParser(prog="python -m repro_torch.search serve")
    ap.add_argument("--pareto", required=True,
                    help="path to a pareto.json written by run_search")
    ap.add_argument("--point", default="best",
                    help="pareto point index, or 'best' = smallest area "
                         "within --max-loss")
    ap.add_argument("--max-loss", type=float, default=0.01)
    ap.add_argument("--dataset", default=None,
                    help="dataset whose test split to serve (default: the "
                         "artifact's recorded dataset)")
    ap.add_argument("--backend", default="kernel", choices=SERVE_BACKENDS,
                    help="kernel = tree_infer_scores (tree) or qmatmul (MLP) "
                         "kernel; reference = the plain tensor dataflow")
    ap.add_argument("--batch", type=int, default=64,
                    help="request size: the test split is served in batches "
                         "of this many feature vectors")
    ap.add_argument("--max-batch", type=int, default=1024,
                    help="largest power-of-two batch bucket")
    ap.add_argument("--repeats", type=int, default=1,
                    help="serve the test split this many times")
    ap.add_argument("--verify-netlist", action="store_true",
                    help="simulate the served design's gate-level netlist "
                         "over every served batch and require equality")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)

    device = _device_or_exit(args.device)
    artifact = _load_artifact_or_exit(args.pareto)
    point = args.point if args.point == "best" else int(args.point)
    server = ClassifyServer.from_artifact(
        artifact, point=point, max_loss=args.max_loss,
        backend=args.backend, max_batch=args.max_batch, device=device)
    idx = server.point_index
    pt = artifact.points[idx]
    if artifact.family == "mlp":
        design = (f"printed MLP {artifact.n_features}-"
                  f"{artifact.n_hidden}-{artifact.n_classes}")
    else:
        design = (f"{artifact.n_trees} tree(s), "
                  f"{artifact.n_comparators} comparators")
    print(f"== serving {args.pareto} point {idx}: {design}, "
          f"acc_loss={pt['acc_loss']:+.4f} norm_area={pt['norm_area']:.3f} "
          f"backend={args.backend} device={server.device} ==")

    dataset = args.dataset or artifact.dataset
    if dataset is None:
        ap.error("--dataset required: this artifact has no 'dataset' label")
    ds = load_dataset(dataset)
    codes = server.featurize(ds.x_test)
    y = ds.y_test.astype(np.int64)

    circuit = None
    if args.verify_netlist:
        from repro_torch.families import get_family
        circuit = get_family(artifact.family).build_point_circuit(artifact,
                                                                  idx)

    n = codes.shape[0]
    preds = np.zeros(n, np.int64)
    n_requests = 0
    n_verified = 0
    t0 = time.perf_counter()
    for _ in range(max(1, args.repeats)):
        for lo in range(0, n, args.batch):
            chunk = codes[lo:lo + args.batch]
            out = server.classify_codes(chunk)
            preds[lo:lo + args.batch] = out
            n_requests += 1
            if circuit is not None:
                sim = netlist.simulate(circuit, chunk).numpy()
                if not np.array_equal(sim, out):
                    print(f"FAIL: request at rows [{lo}, {lo + len(out)}) "
                          f"diverges from the netlist oracle on "
                          f"{int((sim != out).sum())} rows")
                    sys.exit(1)
                n_verified += len(out)
    wall = time.perf_counter() - t0

    acc = float((preds == y).mean())
    recorded = artifact.point_accuracy(idx)
    total = n * max(1, args.repeats)
    print(f"served {total} samples in {n_requests} requests "
          f"({wall:.3f}s, {total / max(wall, 1e-9):,.0f} samples/s, "
          f"{n_requests / max(wall, 1e-9):,.0f} requests/s)")
    print(f"buckets: {server.compiled_buckets()} "
          f"(steps per bucket: {server.stats.steps_per_bucket})")
    print(f"served accuracy on {dataset} test split: {acc:.4f} "
          f"(artifact recorded {recorded:.4f})")
    if abs(acc - recorded) > 1e-6:
        print(f"FAIL: served accuracy {acc:.6f} != recorded "
              f"{recorded:.6f}: the loaded design does not reproduce "
              f"the searched point")
        sys.exit(1)
    if circuit is not None:
        print(f"netlist oracle: {n_verified} served predictions equal "
              f"the gate-level simulation")


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("sweep", "faults"):
        _not_ported(argv[0])
    if argv and argv[0] == "serve":
        return serve_main(argv[1:])
    ap = argparse.ArgumentParser(prog="python -m repro_torch.search")
    ap.add_argument("--dataset", default="seeds",
                    choices=sorted(DATASET_SPECS))
    ap.add_argument("--family", default="tree", choices=("tree", "mlp"),
                    help="classifier family: bespoke decision trees, or "
                         "integer-weight printed MLPs")
    ap.add_argument("--trees", type=int, default=1,
                    help="tree family: 1 = single bespoke DT; K>1 = "
                         "bootstrap forest with a joint 3*sum(N_k)+1-gene "
                         "chromosome (DESIGN.md §16)")
    ap.add_argument("--hidden", type=int, default=16,
                    help="mlp family: hidden-layer width")
    ap.add_argument("--backend", default="reference",
                    choices=("reference", "kernel", "islands"))
    ap.add_argument("--mesh", default=None,
                    help="device mesh spec (not ported)")
    ap.add_argument("--pop", type=int, default=64)
    ap.add_argument("--gens", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="artifact directory")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="generations between checkpoint saves (0 = off); "
                         "also the chunk length (one CUDA graph on the "
                         "card), so one interval = one device dispatch")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint under "
                         "OUT/ckpt (both backends)")
    ap.add_argument("--max-loss", type=float, default=0.01)
    ap.add_argument("--emit-rtl", action="store_true",
                    help="write every pareto point's Verilog under OUT/rtl/")
    ap.add_argument("--verify-rtl", action="store_true",
                    help="netlist-simulate every pareto point over the full "
                         "test set and require it to equal the tensor "
                         "program and the kernel")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)
    if args.backend == "islands":
        _not_ported("islands")
    if args.mesh is not None:
        _not_ported("mesh")
    if (args.emit_rtl or args.verify_rtl) and not args.out:
        ap.error("--emit-rtl/--verify-rtl require --out")
    device = _device_or_exit(args.device)

    from repro_torch import search
    from repro_torch.core import netlist, rtl
    from repro_torch.families import get_family
    from repro_torch.families import printed_mlp as pm

    fam = get_family(args.family)
    if args.family == "mlp":
        problem = fam.build_problem(args.dataset, n_hidden=args.hidden,
                                    device=device)
        kind = f"mlp[h={args.hidden}]"
    else:
        problem = fam.build_problem(args.dataset, n_trees=args.trees,
                                    device=device)
        kind = "tree" if args.trees <= 1 else f"forest[{args.trees}]"
    print(f"== {args.dataset} {fam.describe(problem)} "
          f"exact_area={problem.exact_area_mm2:.1f}mm^2 "
          f"power={area.power_mw(problem.exact_area_mm2):.2f}mW "
          f"device={problem.device} ==")

    cfg = search.SearchConfig(
        backend=args.backend, pop_size=args.pop, n_generations=args.gens,
        seed=args.seed, dataset=args.dataset, out_dir=args.out,
        checkpoint_every=args.checkpoint_every, resume=args.resume,
        emit_rtl=args.emit_rtl, verify_rtl=args.verify_rtl)
    print(f"== run_search backend={cfg.backend} pop={cfg.pop_size} "
          f"gens={cfg.n_generations} ==")
    result = search.run_search(problem, cfg)

    print(f"search wall time: {result.wall_s:.1f}s "
          f"({result.n_evaluations} chromosome evaluations, "
          f"{result.n_dispatches} device dispatches)")
    print("pareto front (acc_loss, normalized area):")
    for o in result.pareto_objs:
        print(f"  {o[0]:+.4f}  {o[1]:.3f}  ({1 / max(o[1], 1e-9):.2f}x smaller)")

    best = result.best_under_loss(args.max_loss)
    if best is None:
        print(f"no design within {args.max_loss:.0%} accuracy loss")
    else:
        o, genes = best
        a_mm2 = float(o[1]) * problem.exact_area_mm2
        print(f"\nselected @<={args.max_loss:.0%} loss: area={a_mm2:.1f}mm^2 "
              f"({1 / o[1]:.2f}x), power={area.power_mw(a_mm2):.2f}mW "
              f"{'< 3mW: printed-battery OK' if area.power_mw(a_mm2) < 3 else ''}")

    if args.out:
        import json
        import os

        import torch

        if best is not None:
            if args.family == "mlp":
                bits_a, margin_a = pm.decode_design(genes)
                h = problem.n_hidden
                w1 = pm.effective_weights(problem.w1_master, bits_a[:h],
                                          margin_a[:h])
                w2 = pm.effective_weights(problem.w2_master, bits_a[h:],
                                          margin_a[h:])
                circuit = netlist.build_mlp_circuit(w1, w2, problem.shift,
                                                    problem.n_classes)
                verilog = rtl.emit_circuit_verilog(
                    circuit, module_name=f"printed_mlp_{args.dataset}")
            else:
                # effective (post-truncation) design: lowering it with
                # trunc=None equals lowering the pre-truncation design with
                # its trunc vector
                bits, t_int, vote_cap = search.decode_chromosome(
                    problem, torch.as_tensor(genes, device=problem.device))
                vote_adder = "approx" if int(vote_cap) == 1 else "exact"
                verilog = rtl.emit_design(
                    search.problem_ptrees(problem), bits.cpu().numpy(),
                    t_int.cpu().numpy(), problem.n_classes,
                    vote_adder=vote_adder)
            path = os.path.join(args.out, f"bespoke_{args.dataset}.v")
            with open(path, "w") as f:
                f.write(verilog)
            print(f"bespoke {kind} RTL written to {path} "
                  f"({len(verilog.splitlines())} lines)")

        with open(os.path.join(args.out, "pareto.json")) as f:
            pts = json.load(f)["pareto"]
        if args.emit_rtl:
            print(f"per-pareto-point RTL: {args.out}/rtl/ ({len(pts)} designs)")
        if args.verify_rtl:
            oracle = ("predict_master == qmatmul" if args.family == "mlp"
                      else "predict_votes == tree_infer_scores")
            print(f"RTL verified: {len(pts)}/{len(pts)} pareto points equal "
                  f"over {problem.x8.shape[0]} test samples (netlist sim == "
                  f"{oracle} kernel)")
        gaps = search.netlist_area_ratios(pts)
        if gaps:
            print(f"estimated-vs-netlist area: netlist/LUT ratio "
                  f"min {min(gaps):.2f} / mean {sum(gaps) / len(gaps):.2f} / "
                  f"max {max(gaps):.2f} across {len(gaps)} points")
        print(f"pareto artifact: {args.out}/pareto.json")


if __name__ == "__main__":
    main()
