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
    PYTHONPATH=src python -m repro_torch.search sweep --datasets all \
        --report [--verify-rtl] [--trees K] [--mlp-datasets seeds,...] \
        [--serial] [--fault-report] [--device cuda]
    PYTHONPATH=src python -m repro_torch.search faults \
        --pareto runs/seeds/pareto.json [--point best] [--device cuda]
    PYTHONPATH=src python -m repro_torch.search --dataset seeds \
        --backend kernel --mesh 2 [--device cpu]
    PYTHONPATH=src python -m repro_torch.search --dataset seeds \
        --backend islands --mesh 2 --migrate-every 5 [--device cpu]
    PYTHONPATH=src python -m repro_torch.search sweep --mesh 2x1 [--device cpu]

The run command trains the exact design (a bespoke tree, with `--trees K` a
bootstrap forest, or with `--family mlp` a printed integer-weight MLP), runs
the NSGA-II search (with `--checkpoint-every N --out D`, saving every N
generations under D/ckpt; `--resume` continues from the newest save) on
the selected backend, prints the pareto front and the best design under the
accuracy-loss budget, and with --out writes pareto.json plus the Verilog of
the selected design (`--emit-rtl`: every point's; `--verify-rtl`: simulate
every point's netlist and require it to equal the tensor program and the
kernel). `serve` serves a pareto.json point over its dataset's test split
and requires the served accuracy to reproduce the recorded one. `sweep`
runs the paper's whole campaign: every dataset's problem padded to its
bucket's shape, a bucket's problems stacked and advanced together (one
fitness launch and one sort a generation for the bucket), each dataset's
pareto.json under OUT/<dataset>/ and, with `--report`, the campaign scored
against the paper's Tables I/II (OUT/sweep_report.json, OUT/REPORT.md);
with `--fault-report` it also runs the stuck-at campaign on each dataset's
best point (OUT/<dataset>/fault_report.json and a robustness table in
REPORT.md). `faults` runs that campaign on a pareto.json's points: every
single stuck-at fault over the test split, Monte-Carlo defect draws under
a seed and the critical gates, into a validated fault_report.json.
All take ``--device`` (default cuda; cpu runs the plain versions of the
kernels).

``--mesh`` (search and sweep) and ``--backend islands`` run on the ranks of
a `torch.distributed` group (`repro_torch.launch.mesh`): under torchrun
the command joins the group that exists; otherwise it starts the mesh's
ranks itself (the ``spawn`` start method, a ``file://`` store in a
temporary directory), rank r on ``cuda:{r % device_count}`` or on the CPU
with ``--device cpu``, over NCCL when every rank has a card of its own and
gloo otherwise. Rank 0 prints and writes the artifacts; an exception in
any rank makes the command exit non-zero. ``--compilation-cache DIR``
keeps the kernels' libraries in DIR, so a second run builds nothing.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.core import area
from repro_torch.datasets import DATASET_SPECS, load_dataset

def _enable_cache(cache_dir: str | None) -> None:
    if cache_dir:
        from repro_torch.runtime import compile_cache
        compile_cache.enable(cache_dir)


def _on_ranks(run, args, spec: str | None, axes) -> None:
    """``run(args)`` on every rank of the mesh ``spec`` asks for (in this
    process when it needs one rank and no group exists); rank 0 alone
    prints."""
    from repro_torch.launch import mesh as _mesh

    device = _device_or_exit(args.device)
    try:
        n = _mesh.mesh_size(spec, axes, device.type)
    except ValueError as e:
        print(f"error: --mesh: {e}", file=sys.stderr)
        raise SystemExit(2)
    if n > 1:
        n_cards = _mesh.auto_extent(device.type)
        backend = _mesh.collective_backend(device.type, n, n_cards)
        print(f"== mesh {spec}: {n} ranks over {backend} ({device.type}, "
              f"{n_cards} card(s)) ==", flush=True)
        if device.type == "cuda":   # build once, before the ranks start
            from repro_torch.kernels import _build
            _build.build()
    # a spawned rank finds functions by their module's name, which is
    # "__main__" under `python -m`: hand it this module's own copy
    import importlib
    cli = importlib.import_module("repro_torch.search.__main__")
    _mesh.run_ranks(cli._rank_cli, n, device,
                    (getattr(cli, run.__name__), args))


def _rank_cli(run, args) -> None:
    """One rank of a CLI run: rank 0 prints, the others stay quiet."""
    import contextlib
    import io

    from repro_torch.launch import mesh as _mesh

    if _mesh.is_writer():
        return run(args)
    with contextlib.redirect_stdout(io.StringIO()):
        return run(args)


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
    ap.add_argument("--compilation-cache", default=None, metavar="DIR",
                    help="keep the kernels' built libraries in DIR: a "
                         "second run builds nothing")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)
    _enable_cache(args.compilation_cache)

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


def sweep_main(argv=None) -> None:
    """`python -m repro_torch.search sweep`: the batched full-suite
    campaign."""
    from repro_torch.search import sweep as sweep_mod

    ap = argparse.ArgumentParser(prog="python -m repro_torch.search sweep")
    ap.add_argument("--datasets", default="all",
                    help="comma-separated dataset names, or 'all' for the "
                         "paper's full 10-dataset suite")
    ap.add_argument("--trees", type=int, default=1,
                    help="1 = single bespoke DT per dataset; K>1 = bootstrap "
                         "forest per dataset (joint chromosome)")
    ap.add_argument("--mlp-datasets", default="",
                    help="comma-separated datasets to ALSO search as printed "
                         "MLPs (campaign keys suffixed _mlp); the bucket "
                         "planner keeps families in separate buckets")
    ap.add_argument("--hidden", type=int, default=16,
                    help="printed-MLP hidden-layer width for --mlp-datasets")
    ap.add_argument("--pop", type=int, default=64)
    ap.add_argument("--gens", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/sweep",
                    help="artifact root: per-dataset pareto.json under "
                         "OUT/<dataset>/, report at OUT/sweep_report.json")
    ap.add_argument("--max-buckets", type=int,
                    default=sweep_mod.DEFAULT_MAX_BUCKETS,
                    help="merge shape buckets down to at most this many "
                         "batched programs")
    ap.add_argument("--serial", action="store_true",
                    help="run the per-problem serial loop (the oracle the "
                         "batched path is held to)")
    ap.add_argument("--mesh", default=None,
                    help="mesh spec: 'KxN' = K ranks on the bucket axis x N "
                         "on the population axis, 'N'/'auto' = population "
                         "axis only; default: one device")
    ap.add_argument("--compilation-cache", default=None, metavar="DIR",
                    help="keep the kernels' built libraries in DIR: a "
                         "second run builds nothing")
    ap.add_argument("--emit-rtl", action="store_true",
                    help="write every pareto point's Verilog under "
                         "OUT/<dataset>/rtl/")
    ap.add_argument("--verify-rtl", action="store_true",
                    help="netlist-simulate every pareto point of every "
                         "dataset and require it to equal the tensor "
                         "program and the kernel")
    ap.add_argument("--report", action="store_true",
                    help="score the campaign against paper Tables I/II "
                         "(OUT/sweep_report.json + OUT/REPORT.md)")
    ap.add_argument("--fault-report", action="store_true",
                    help="run the stuck-at robustness campaign on every "
                         "dataset's best-under-loss point (DESIGN.md §17): "
                         "OUT/<dataset>/fault_report.json + a robustness-"
                         "vs-area section in REPORT.md")
    ap.add_argument("--fault-chunk", type=int, default=None,
                    help="fault lanes per dispatch of --fault-report, as "
                         "faults --chunk (default: every lane in one "
                         "kernel launch on the card; auto-sized to the "
                         "memory budget on the CPU)")
    ap.add_argument("--max-loss", type=float, default=0.01)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)
    names = (sorted(DATASET_SPECS) if args.datasets == "all"
             else [n.strip() for n in args.datasets.split(",") if n.strip()])
    mlp_names = [n.strip() for n in args.mlp_datasets.split(",") if n.strip()]
    unknown = [n for n in names + mlp_names if n not in DATASET_SPECS]
    if unknown:
        ap.error(f"unknown datasets: {unknown}; options: "
                 f"{sorted(DATASET_SPECS)}")
    if args.mesh and args.serial:
        ap.error("--mesh requires the batched path (the serial loop is the "
                 "mesh-free oracle)")
    _enable_cache(args.compilation_cache)
    args.names, args.mlp_names = names, mlp_names
    _on_ranks(_sweep_run, args, args.mesh, ("bucket", "pop"))


def _sweep_run(args) -> None:
    """The sweep on this rank (every rank of a mesh runs the campaign;
    rank 0 writes the artifacts, the report and the fault reports)."""
    from repro_torch.launch import mesh as _mesh
    from repro_torch.launch.mesh import rank_device
    from repro_torch.search import sweep as sweep_mod

    names, mlp_names = args.names, args.mlp_names
    device = rank_device(args.device)

    kind = "tree" if args.trees <= 1 else f"forest[{args.trees}]"
    extra = (f" + {len(mlp_names)} printed-MLP datasets" if mlp_names else "")
    print(f"== sweep: {len(names)} datasets, {kind} per dataset{extra}, "
          f"pop={args.pop} gens={args.gens} device={device} ==")
    problems = sweep_mod.build_problems(names, n_trees=args.trees,
                                        verbose=True, mlp_datasets=mlp_names,
                                        n_hidden=args.hidden, device=device)
    cfg = sweep_mod.SweepConfig(
        pop_size=args.pop, n_generations=args.gens, seed=args.seed,
        vmapped=not args.serial, max_buckets=args.max_buckets,
        mesh=args.mesh, out_dir=args.out, emit_rtl=args.emit_rtl,
        verify_rtl=args.verify_rtl)
    sweep = sweep_mod.run_sweep(problems, cfg)
    if not _mesh.is_writer():
        return

    for i, run in enumerate(sweep.bucket_runs):
        d = run.bucket.dims
        if run.bucket.family == "tree":
            dims_s = f"(N={d[0]}, L={d[1]}, C={d[2]}, F={d[3]}, B={d[4]})"
        else:
            dims_s = f"(H={d[0]}, C={d[1]}, F={d[2]}, B={d[3]})"
        print(f"bucket {i}: [{run.bucket.family}] "
              f"{', '.join(run.bucket.names)} -> padded {dims_s}, "
              f"{run.n_dispatches} dispatches, {run.wall_s:.1f}s")
    print(f"campaign: {sweep.n_dispatches} dispatches over "
          f"{len(sweep.bucket_runs)} buckets (serial per-dataset baseline: "
          f"{sweep.serial_baseline_dispatches()}), wall {sweep.wall_s:.1f}s")

    for name in sorted(sweep.results):
        result = sweep.results[name]
        problem = problems[name]
        best = result.best_under_loss(args.max_loss)
        if best is None:
            line = f"no design within {args.max_loss:.0%} loss"
        else:
            o, _ = best
            a_mm2 = float(o[1]) * problem.exact_area_mm2
            line = (f"@<={args.max_loss:.0%} loss: "
                    f"{1 / max(float(o[1]), 1e-9):.2f}x smaller, "
                    f"{a_mm2:.1f}mm^2, {area.power_mw(a_mm2):.2f}mW")
        print(f"  {name}: exact_acc={problem.exact_accuracy:.3f} "
              f"pareto={len(result.pareto_objs)} pts; {line}")
    if args.verify_rtl:
        n_pts = sum(len(r.pareto_objs) for r in sweep.results.values())
        print(f"RTL verified: {n_pts} pareto points across {len(problems)} "
              f"problems (netlist sim == tensor predict == kernel route)")

    if args.fault_report:
        import os
        import time

        from repro_torch.search import load_pareto_artifact, robustness

        print(f"== fault campaign: best point per dataset, defect_rate="
              f"{robustness.DEFAULT_DEFECT_RATE:.0%}, "
              f"{robustness.DEFAULT_TRIALS} MC trials ==")
        t0 = time.perf_counter()
        n_reports = 0
        for name in sorted(sweep.results):
            pareto_path = os.path.join(args.out, name, "pareto.json")
            if not os.path.exists(pareto_path):
                continue
            artifact = load_pareto_artifact(pareto_path)
            problem = problems[name]
            try:
                payload = robustness.run_campaign(
                    artifact, problem.x8, problem.y, source=pareto_path,
                    dataset=name, point="best", max_loss=args.max_loss,
                    chunk=args.fault_chunk, device=device)
            except ValueError as e:   # e.g. no point within the budget
                print(f"  {name}: skipped ({e})")
                continue
            out_path = robustness.write_fault_report(
                payload, os.path.join(args.out, name, "fault_report.json"))
            n_reports += 1
            row = payload["points"][0]
            print(f"  {name}: point {row['point']} "
                  f"({row['n_sites']} sites) baseline "
                  f"{row['baseline_accuracy']:.4f} -> 1-fault worst "
                  f"{row['single_fault']['worst_accuracy']:.4f}, "
                  f"MC {row['monte_carlo']['expected_accuracy']:.4f} "
                  f"-> {out_path}")
        print(f"fault campaign: {n_reports} reports in "
              f"{time.perf_counter() - t0:.1f} s")

    if args.report:
        meta = {"datasets": args.datasets, "trees": args.trees,
                "pop": args.pop, "gens": args.gens, "seed": args.seed,
                "mode": "serial" if args.serial else "vmapped"}
        if mlp_names:
            meta["mlp_datasets"] = args.mlp_datasets
            meta["hidden"] = args.hidden
        json_path, md_path = sweep_mod.write_sweep_report(
            sweep, problems, args.out, meta=meta, max_loss=args.max_loss)
        print(f"report: {json_path} + {md_path}")
    print(f"artifacts: {args.out}/<dataset>/pareto.json")


def faults_main(argv=None) -> None:
    """`python -m repro_torch.search faults`: stuck-at robustness campaign.

    Loads a `pareto.json`, rebuilds the selected point(s)' gate-level
    circuits through the family registry, and runs the DESIGN.md §17
    campaign on ``--device``: exhaustive single stuck-at over every fault
    site, Monte-Carlo defect draws under a fixed seed, and the
    critical-gate ranking, writing a validated `fault_report.json` next to
    the artifact (or to --out).
    """
    import os

    from repro_torch.datasets import quantize_u8
    from repro_torch.search import robustness

    ap = argparse.ArgumentParser(prog="python -m repro_torch.search faults")
    ap.add_argument("--pareto", required=True,
                    help="path to a pareto.json written by run_search/sweep")
    ap.add_argument("--point", default="all",
                    help="pareto point index, 'best' = smallest area within "
                         "--max-loss, or 'all' (default)")
    ap.add_argument("--max-loss", type=float, default=0.01)
    ap.add_argument("--dataset", default=None,
                    help="dataset whose test split drives the campaign "
                         "(default: the artifact's recorded dataset)")
    ap.add_argument("--defect-rate", type=float,
                    default=robustness.DEFAULT_DEFECT_RATE,
                    help="Monte-Carlo iid per-site defect probability")
    ap.add_argument("--trials", type=int, default=robustness.DEFAULT_TRIALS,
                    help="Monte-Carlo defect draws per point")
    ap.add_argument("--mc-seed", type=int,
                    default=robustness.DEFAULT_MC_SEED,
                    help="seed of the Monte-Carlo masks (fixed seed -> the "
                         "same report on any device)")
    ap.add_argument("--top-k", type=int, default=robustness.DEFAULT_TOP_K,
                    help="critical gates reported per point")
    ap.add_argument("--chunk", type=int, default=None,
                    help="fault lanes per dispatch (default: every lane in "
                         "one kernel launch on the card; auto-sized to the "
                         "memory budget on the CPU)")
    ap.add_argument("--out", default=None,
                    help="fault_report.json path (default: next to --pareto)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the CPU)")
    args = ap.parse_args(argv)

    device = _device_or_exit(args.device)
    artifact = _load_artifact_or_exit(args.pareto)
    dataset = args.dataset or artifact.dataset
    if dataset is None:
        ap.error("--dataset required: this artifact has no 'dataset' label")
    ds_name = dataset.removesuffix("_mlp")
    if ds_name not in DATASET_SPECS:
        ap.error(f"unknown dataset {ds_name!r}; options: "
                 f"{sorted(DATASET_SPECS)}")
    ds = load_dataset(ds_name)
    x8 = quantize_u8(ds.x_test)
    y = np.asarray(ds.y_test, np.int64)

    print(f"== fault campaign: {args.pareto} [{artifact.family}] on "
          f"{ds_name} ({x8.shape[0]} test vectors), point={args.point}, "
          f"defect_rate={args.defect_rate:.2%}, {args.trials} MC trials, "
          f"seed={args.mc_seed}, device={device} ==")
    try:
        payload = robustness.run_campaign(
            artifact, x8, y, source=args.pareto, dataset=dataset,
            point=args.point, max_loss=args.max_loss,
            defect_rate=args.defect_rate, n_trials=args.trials,
            seed=args.mc_seed, top_k=args.top_k, chunk=args.chunk,
            verbose=True, device=device)
    except ValueError as e:
        print(f"error: fault campaign: {e}", file=sys.stderr)
        raise SystemExit(2)
    out = args.out or os.path.join(
        os.path.dirname(args.pareto) or ".", "fault_report.json")
    robustness.write_fault_report(payload, out)
    worst = min(p["single_fault"]["worst_accuracy"]
                for p in payload["points"])
    print(f"campaign: {len(payload['points'])} point(s), worst single-fault "
          f"accuracy {worst:.4f}; report: {out}")


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "sweep":
        return sweep_main(argv[1:])
    if argv and argv[0] == "serve":
        return serve_main(argv[1:])
    if argv and argv[0] == "faults":
        return faults_main(argv[1:])
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
                    help="mesh spec: 'N' or 'auto' splits the population "
                         "over N ranks / one rank a card (islands: the "
                         "ring's size, default auto); default: one device")
    ap.add_argument("--compilation-cache", default=None, metavar="DIR",
                    help="keep the kernels' built libraries in DIR: a "
                         "second run builds nothing")
    ap.add_argument("--block-p", type=int, default=8,
                    help="accepted for the JAX package's command lines and "
                         "ignored: it tiles the Pallas grid (DESIGN.md "
                         "§12); the CUDA kernels choose their own tiles, "
                         "so it changes no result")
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
                         "OUT/ckpt (every backend, islands included)")
    ap.add_argument("--migrate-every", type=int, default=5,
                    help="islands backend: generations between ring "
                         "migrations (checkpoints land on round boundaries)")
    ap.add_argument("--n-migrate", type=int, default=4,
                    help="islands backend: elites migrated per round")
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
    if (args.emit_rtl or args.verify_rtl) and not args.out:
        ap.error("--emit-rtl/--verify-rtl require --out")
    _enable_cache(args.compilation_cache)
    if args.backend == "islands":
        _on_ranks(_search_run, args, args.mesh or "auto", ("data",))
    else:
        _on_ranks(_search_run, args, args.mesh, ("pop",))


def _search_run(args) -> None:
    """The search on this rank (every rank of a mesh searches; rank 0
    writes the artifacts)."""
    from repro_torch.launch import mesh as _mesh

    device = _mesh.rank_device(args.device)

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
        mesh=args.mesh, migrate_every=args.migrate_every,
        n_migrate=args.n_migrate, emit_rtl=args.emit_rtl,
        verify_rtl=args.verify_rtl, block_p=args.block_p)
    print(f"== run_search backend={cfg.backend} pop={cfg.pop_size} "
          f"gens={cfg.n_generations} ==")
    result = search.run_search(problem, cfg)
    if not _mesh.is_writer():
        return

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
