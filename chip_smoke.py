#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA card

Phases, each of which stops the script with a non-zero exit on failure:

1. Build the three Hopper kernels from `src/repro_torch/csrc/` (one nvcc per
   source, all started together, `sm_90a`) and report nvcc's register and
   spill summary.
2. Hold each kernel to its plain PyTorch version on the card, with exact
   equality, at the main path's shapes (the `har` dataset: N=588
   comparators, L=589 leaves, B=3090 test rows, C=6 classes); check that
   the kernel backend scores the exact design (0, 1); and time both on the
   device (a `torch.profiler` trace of back-to-back calls) beside the
   kernel's bound: the larger of its bytes over 3.35 TB/s and its
   operations over the peak rate of their type (1979 TOP/s int8 for the
   tree dataflow, 67 TFLOP/s float32 outside the tensor cores for the
   domination compares).
3. The main path through the user's entry points: train the `har` tree,
   `run_search(backend="kernel", pop_size=512, verify_rtl=True)` into a
   temporary `pareto.json`, then `ClassifyServer.from_artifact` serving
   requests of 1, 37, 1024 and 3090 rows, each checked against the
   gate-level netlist simulation. The kernels' launch counters are set to 0
   just before and read just after, and every kernel must have launched.
4. Print the kernel list, the card's name and power limit, one JSON line
   of per-kernel results, and last `{"ok": true, "device": {...}}`.

Without a CUDA device, or without the repository's `src/` beside it, the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DATASET = "har"
POP = 512
GENS = 8
SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT8_OPS_PER_S = 1979e12       # H100 SXM tensor cores, int8 dense
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
TPU_KERNELS = {  # kernel -> (port source, the TPU kernel it replaces)
    "fitness_errors": ("src/repro_torch/csrc/fitness.cu",
                       "src/repro/kernels/fitness.py:109"),
    "domination_block": ("src/repro_torch/csrc/domination.cu",
                         "src/repro/kernels/domination.py:57"),
    "tree_infer_scores": ("src/repro_torch/csrc/tree_infer.cu",
                          "src/repro/kernels/tree_infer.py:81"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def device_ms(fn, reps: int, kernel: str | None = None) -> float | None:
    """Device time of one call of ``fn``, read from a `torch.profiler` trace
    of ``reps`` back-to-back calls after a warm-up call: the summed time of
    the device activities (kernels, copies, fills) whose name holds
    ``kernel`` (every one of them when None), over ``reps``. None when the
    trace holds no such activity."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and (kernel is None or kernel in e.name)]
    return sum(us) / reps / 1e3 if us else None


def stream_ms(fn, reps: int) -> float:
    """Time of one call of ``fn`` on the stream: CUDA events around ``reps``
    back-to-back calls after a warm-up call. It holds whatever host time
    keeps the stream waiting between calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def timed(kernel_fn, plain_fn, kernel: str, reps: int, plain_reps: int):
    """(ms, plain_ms, text): the device time of the CUDA kernel named
    ``kernel`` per call of ``kernel_fn`` and the device time of every
    activity of ``plain_fn`` per call, each from a profiler trace, or from
    CUDA events where the trace holds no device activity; the text also
    gives both functions' time per call on the stream."""
    ms, plain_ms = (device_ms(kernel_fn, reps, kernel),
                    device_ms(plain_fn, plain_reps))
    on_stream = stream_ms(kernel_fn, reps), stream_ms(plain_fn, plain_reps)
    how = "device time (profiler)"
    if ms is None or plain_ms is None:
        ms, plain_ms = on_stream
        how = "stream time (CUDA events; the profiler saw no device activity)"
    text = (f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms {how}; per call on "
            f"the stream {on_stream[0]:.4f} / {on_stream[1]:.4f} ms")
    return ms, plain_ms, text


def bound(n_bytes: float, n_ops: float, ops_per_s: float):
    """(bound_ms, bound_by): the least time for the bytes and operations."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tree_ops(p: int, b: int, n: int, l: int, c: int) -> int:
    """Integer operations of the tree dataflow for p chromosomes on b rows:
    shift and compare per comparator, the path product (2NL) and the vote
    product (2LC) per (chromosome, row)."""
    return p * b * (2 * n + 2 * n * l + 2 * l * c)


def ptxas_summary(name: str) -> str:
    from repro_torch.kernels import _build

    text = _build.build_log(name)
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", text)]
    return (f"{len(regs)} kernels, registers max {max(regs, default=0)}, "
            f"spill stores max {max(spills, default=0)} bytes")


def phase_build() -> float:
    from repro_torch.kernels import _build

    seconds = _build.build()
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: {seconds:.1f} s "
        f"for {', '.join(_build.SOURCES)}")
    for name in _build.SOURCES:
        log(f"[build] {name}: {ptxas_summary(name)}")
    return seconds


def phase_kernels(problem, rng) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.core import quant
    from repro_torch.kernels import domination, fitness, ops, tree_infer
    from repro_torch.search import make_kernel_fitness

    dev = problem.device
    n, l, c = problem.n_comparators, problem.n_leaves, problem.n_classes
    b = int(problem.y.shape[0])
    n_feat = problem.n_features
    results = {}

    def record(name, err, ms, plain_ms, bound_ms, bound_by):
        results[name] = dict(
            name=name, route="cuda", source=TPU_KERNELS[name][0],
            replaces=TPU_KERNELS[name][1], launches=0, max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None)

    # fitness_errors: P random chromosomes (the exact design first), both
    # vote caps, on the problem's own operands
    genes = rng.random((POP, problem.n_genes), dtype=np.float32)
    genes[0] = problem.exact_genes()
    genes[1:, -1] = rng.random(POP - 1) < 0.5     # approximate vote adder
    genes_t = torch.as_tensor(genes, device=dev)
    shift, thr, _, cap = ops.decode_population_full(problem.threshold, genes_t)
    check(sorted(set(cap.tolist())) == [1, quant.NO_VOTE_CAP],
          "fitness chromosomes do not mix both vote caps")
    fit_ops = ops.prepare_fitness_operands(
        problem.x_sel, problem.y, problem.path, problem.path_len,
        problem.n_neg, problem.leaf_class, c)
    got = fitness.fitness_correct_counts(fit_ops, shift, thr, cap)
    torch.cuda.synchronize()
    want = fitness.fitness_correct_counts_plain(fit_ops, shift, thr, cap)
    err = int((got.long() - want.long()).abs().max())
    check(err == 0, f"fitness_errors differs from its plain version by {err}")
    check(int(got[0]) == round(problem.exact_accuracy * b),
          "fitness_errors miscounts the exact design")
    exact_objs = make_kernel_fitness(problem)(genes_t[:1])
    check(exact_objs.tolist() == [[0.0, 1.0]],
          f"the kernel backend scores the exact design "
          f"{exact_objs.tolist()[0]}, not (0, 1)")
    ms, plain_ms, text = timed(
        lambda: fitness.fitness_correct_counts(fit_ops, shift, thr, cap),
        lambda: fitness.fitness_correct_counts_plain(fit_ops, shift, thr, cap),
        "fitness_kernel", reps=10, plain_reps=3)
    words = fit_ops.pos.shape[1]
    n_ops = tree_ops(POP, b, n, l, c)
    n_bytes = (b * n + 2 * POP * n * 4 + 2 * l * words * 4 + 2 * l * 4
               + b * 4 + POP * 4 + POP * 4)
    bms, by = bound(n_bytes, n_ops, INT8_OPS_PER_S)
    log(f"[kernel] fitness_errors P={POP} B={b} N={n} L={l} C={c}: equal; "
        f"{text}; bound {bms:.4f} ms ({by}; {n_ops:.4g} int ops, "
        f"{n_bytes} bytes)")
    record("fitness_errors", float(err), ms, plain_ms, bms, by)

    # domination_block: the GA pool (2P rows) against itself, and a slab
    errs, first = [], None
    for pi, pj in ((2 * POP, 2 * POP), (POP // 2, 2 * POP)):
        oi = torch.as_tensor((rng.integers(0, 64, (pi, 2)) / 63)
                             .astype(np.float32), device=dev)
        oj = oi if pi == pj else torch.as_tensor(
            (rng.integers(0, 64, (pj, 2)) / 63).astype(np.float32),
            device=dev)
        got = domination.domination_block(oi, oj)
        torch.cuda.synchronize()
        want = domination.domination_block_plain(oi, oj)
        err = int((got.int() - want.int()).abs().max())
        check(err == 0, f"domination_block {pi}x{pj} differs from its plain "
              f"version")
        errs.append(err)
        ms, plain_ms, text = timed(
            lambda: domination.domination_block(oi, oj),
            lambda: domination.domination_block_plain(oi, oj),
            "domination_kernel", reps=50, plain_reps=50)
        n_ops = 3 * 2 * pi * pj
        n_bytes = (pi + pj) * 2 * 4 + pi * pj
        bms, by = bound(n_bytes, n_ops, FP32_OPS_PER_S)
        log(f"[kernel] domination_block {pi}x{pj} M=2: equal; {text}; "
            f"bound {bms:.5f} ms ({by}; {n_ops} compares, {n_bytes} bytes)")
        first = first or (ms, plain_ms, bms, by)
    record("domination_block", float(max(errs)), *first)

    # tree_infer_scores: serving buckets (P=1), the --verify-rtl leg
    # (P=1, B=3090) and a population slab (P=8, B=3090)
    operands = ops.prepare_operands(
        problem.feature, problem.path, problem.path_len, problem.n_neg,
        problem.leaf_class, c, n_feat)
    errs, main = [], None
    for p, rows in ((1, 1), (1, 37), (1, 1024), (1, b), (8, b)):
        g = genes_t[:p] if p > 1 else genes_t[1:2]
        shift_p, thr_p, _ = ops.decode_population(problem.threshold, g)
        x8 = problem.x8[:rows].contiguous()
        got = tree_infer.tree_infer_scores(x8, operands, shift_p, thr_p)
        torch.cuda.synchronize()
        want = tree_infer.tree_infer_scores_plain(x8, operands, shift_p,
                                                  thr_p)
        err = int((got - want).abs().max())
        check(err == 0, f"tree_infer_scores P={p} B={rows} differs from its "
              f"plain version by {err}")
        errs.append(err)
        ms, plain_ms, text = timed(
            lambda: tree_infer.tree_infer_scores(x8, operands, shift_p, thr_p),
            lambda: tree_infer.tree_infer_scores_plain(x8, operands, shift_p,
                                                       thr_p),
            "tree_infer_kernel", reps=20, plain_reps=5)
        n_ops = tree_ops(p, rows, n, l, c)
        n_bytes = (rows * n_feat * 4 + n * 4 + 2 * p * n * 4
                   + 2 * l * operands.pos.shape[1] * 4 + 2 * l * 4
                   + p * rows * c * 4)
        bms, by = bound(n_bytes, n_ops, INT8_OPS_PER_S)
        log(f"[kernel] tree_infer_scores P={p} B={rows}: equal; {text}; "
            f"bound {bms:.5f} ms ({by}; {n_ops:.4g} int ops, {n_bytes} bytes)")
        if (p, rows) == (1, b):
            main = (ms, plain_ms, bms, by)
    record("tree_infer_scores", float(max(errs)), *main)
    return results


def phase_main_path(problem, out_dir: str) -> dict:
    """search -> pareto.json (netlists verified) -> serve, counted."""
    from repro_torch import kernels, search
    from repro_torch.core import netlist
    from repro_torch.datasets import load_dataset
    from repro_torch.runtime.classify import ClassifyServer

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = search.run_search(problem, backend="kernel", pop_size=POP,
                               n_generations=GENS, seed=SEED, dataset=DATASET,
                               out_dir=out_dir, verify_rtl=True)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    searched = kernels.launch_counts()
    objs = result.pareto_objs
    log(f"[main] run_search {DATASET} backend=kernel pop={POP} gens={GENS}: "
        f"search {result.wall_s:.2f} s, pareto.json + verify_rtl "
        f"{t_run - result.wall_s:.2f} s over {len(objs)} points; "
        f"{result.n_dispatches} generation-loop calls; launches {searched}")
    check(searched["fitness_errors"] >= 1 + GENS,
          "fitness_errors launched fewer than once per generation")
    check(searched["domination_block"] >= 1 + GENS,
          "domination_block launched fewer than once per generation")
    check(searched["tree_infer_scores"] >= len(objs),
          "tree_infer_scores launched fewer than once per pareto point")
    exact_on_front = bool(((objs[:, 0] == 0) & (objs[:, 1] == 1)).any())
    check(bool(((objs[:, 0] <= 0) & (objs[:, 1] <= 1)).any()),
          "no front point matches or dominates the exact design (0, 1)")
    check(np.isfinite(objs).all() and objs.shape[1] == 2,
          "pareto objectives are not finite (K, 2)")
    log(f"[main] front: {len(objs)} points, loss "
        f"[{objs[:, 0].min():+.4f}, {objs[:, 0].max():+.4f}], area "
        f"[{objs[:, 1].min():.4f}, {objs[:, 1].max():.4f}]; exact design "
        f"(0, 1) {'on' if exact_on_front else 'dominated on'} the front")

    art = search.load_pareto_artifact(str(pathlib.Path(out_dir) /
                                          "pareto.json"))
    check(art.payload["rtl_verified"] and all(
        p.get("verified") for p in art.points),
        "pareto.json does not record every point as verified")
    idx = art.best_under_loss(0.01)
    if idx is None:
        idx = min(range(len(art.points)),
                  key=lambda i: art.points[i]["acc_loss"])
    server = ClassifyServer.from_artifact(art, point=idx, backend="kernel",
                                          device=problem.device)
    bits, t_int, trunc, vote_adder = art.point_design(idx)
    circuit = netlist.build_circuit(art.ptrees(), bits, t_int, art.n_classes,
                                    trunc=trunc, vote_adder=vote_adder)
    ds = load_dataset(DATASET)
    codes = server.featurize(ds.x_test)
    latency = {}
    for rows in (1, 37, 1024, codes.shape[0]):
        t0 = time.perf_counter()
        served = server.classify(codes[:rows])
        latency[rows] = (time.perf_counter() - t0) * 1e3
        gates = netlist.simulate(circuit, torch.as_tensor(
            codes[:rows], device=problem.device)).cpu().numpy()
        check(np.array_equal(served, gates),
              f"served predictions of a {rows}-row request differ from the "
              f"netlist on {int((served != gates).sum())} rows")
    acc = float((served == ds.y_test).mean())
    check(abs(acc - art.point_accuracy(idx)) <= 1e-6,
          f"served accuracy {acc} != recorded {art.point_accuracy(idx)}")
    counts = kernels.launch_counts()
    check(all(v > 0 for v in counts.values()),
          f"a kernel of the path never launched: {counts}")
    log(f"[main] served point {idx} (acc_loss {art.points[idx]['acc_loss']:+.4f}, "
        f"norm_area {art.points[idx]['norm_area']:.4f}) over requests of "
        f"{sorted(latency)} rows == netlist simulation; accuracy {acc:.6f} "
        f"== recorded; latency ms {json.dumps({k: round(v, 3) for k, v in latency.items()})}; "
        f"buckets {server.compiled_buckets()}")
    log(f"[main] launches over search + serve: {counts}")
    return dict(counts=counts, state=result.state)


def phase_breakdown(problem, state, rng) -> None:
    """Where one generation's time goes: a whole `make_step` against its
    fitness call and its survivor selection (sort + crowding), host clock
    around synchronised calls, median of 3; the sort's fronts are its host
    round trips."""
    from repro_torch.core import nsga2
    from repro_torch.search import make_kernel_fitness

    fitness = make_kernel_fitness(problem)
    cfg = nsga2.NSGA2Config(pop_size=POP)
    step = nsga2.make_step(fitness, cfg)
    gen = torch.Generator(device=problem.device).manual_seed(SEED + 1)

    def host_ms(fn, reps=3):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    draws = nsga2.draw_step(gen, POP, problem.n_genes, problem.device)
    t_step = host_ms(lambda: step(state, draws))
    t_fit = host_ms(lambda: fitness(state.genes))
    pool = torch.cat([state.objs, fitness(state.genes)])
    t_surv = host_ms(lambda: nsga2.survivors(pool, POP))
    rank, _, _ = nsga2.survivors(pool, POP)
    fronts = int(rank.max()) + 1
    log(f"[breakdown] one generation (pop {POP}, pool {2 * POP}): step "
        f"{t_step:.2f} ms = fitness {t_fit:.2f} ms + survivors {t_surv:.2f} "
        f"ms ({fronts} fronts, one host sync each) + operators and draws "
        f"{t_step - t_fit - t_surv:.2f} ms")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA "
             "device and prints no result without one")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    from repro_torch import search
    from repro_torch.core.train import train_tree
    from repro_torch.core.tree import to_parallel
    from repro_torch.datasets import load_dataset

    t_start = time.perf_counter()
    phase_build()

    t0 = time.perf_counter()
    ds = load_dataset(DATASET)
    tree = train_tree(ds.x_train, ds.y_train, ds.n_classes)
    problem = search.build_problem(to_parallel(tree), ds.x_test, ds.y_test,
                                   device="cuda")
    log(f"[setup] {DATASET}: N={problem.n_comparators} L={problem.n_leaves} "
        f"B={problem.x8.shape[0]} C={problem.n_classes} "
        f"F={problem.n_features}, exact accuracy {problem.exact_accuracy:.6f}"
        f" ({time.perf_counter() - t0:.1f} s to load, train and build)")

    rng = np.random.default_rng(SEED)
    results = phase_kernels(problem, rng)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        main_path = phase_main_path(problem, out_dir)
    phase_breakdown(problem, main_path["state"], rng)
    for name, count in main_path["counts"].items():
        results[name]["launches"] = count

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log("kernels: " + ", ".join(results))
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({"kernels": list(results.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
