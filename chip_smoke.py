#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA card

Phases, each of which stops the script with a non-zero exit on failure:

1. Build the four Hopper kernels from `src/repro_torch/csrc/` (one nvcc per
   source, all started together, `sm_90a`) and report nvcc's register and
   spill summary.
2. Hold each kernel to its plain PyTorch version on the card at the main
   paths' shapes (the `har` dataset: a tree of N=588 comparators and L=589
   leaves, and a printed MLP of F=561 features, H=16 hidden and C=6 output
   neurons, over B=3090 test rows): exact equality for the tree kernels
   and for `qmatmul` on integer codes, a stated tolerance for `qmatmul` on
   float inputs; check that each kernel backend scores the exact design
   (0, 1); and time both on the device (a `torch.profiler` trace of
   back-to-back calls) beside the kernel's bound: the larger of its bytes
   over 3.35 TB/s and its operations over the peak rate of their type
   (1979 TOP/s int8 for the tree dataflow and for `qmatmul` on integer
   codes, 67 TFLOP/s float32 outside the tensor cores for the domination
   compares and `qmatmul` on float32 x, 989 TFLOP/s bf16), and,
   for `qmatmul`, beside the one PyTorch call that computes the same
   function (`torch.mm`, TF32 off).
3. The tree main path through the user's entry points: train the `har`
   tree, `run_search(backend="kernel", pop_size=512, verify_rtl=True)` into
   a temporary `pareto.json`, then `ClassifyServer.from_artifact` serving
   requests of 1, 37, 1024 and 3090 rows, each checked against the
   gate-level netlist simulation.
4. The printed-MLP main path the same way: `har` at hidden 16, pop 512,
   then `pendigits` at pop 128 (its exact design is far from chance), each
   served request checked against the netlist and the integer predict.
   Before each path the kernels' launch counters are set to 0 and just
   after they are read; every kernel of the path must have launched.
5. Print where one generation's time goes on each path, the kernel list,
   the card's name and power limit, one JSON line of per-kernel results,
   and last `{"ok": true, "device": {...}}`.

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
MLP_HIDDEN = 16
MLP_RUNS = (("har", 512), ("pendigits", 128))    # (dataset, pop), GENS each
QMM_RTOL, QMM_ATOL = 1e-5, 1e-3   # qmatmul on float inputs (module doc)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT8_OPS_PER_S = 1979e12       # H100 SXM tensor cores, int8 dense
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM tensor cores, bf16 dense
TPU_KERNELS = {  # kernel -> (port source, the TPU kernel it replaces)
    "fitness_errors": ("src/repro_torch/csrc/fitness.cu",
                       "src/repro/kernels/fitness.py:109"),
    "domination_block": ("src/repro_torch/csrc/domination.cu",
                         "src/repro/kernels/domination.py:57"),
    "tree_infer_scores": ("src/repro_torch/csrc/tree_infer.cu",
                          "src/repro/kernels/tree_infer.py:81"),
    "qmatmul": ("src/repro_torch/csrc/qmatmul.cu",
                "src/repro/kernels/qmatmul.py:40"),
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


TREE_KERNELS = ("fitness_errors", "domination_block", "tree_infer_scores")


def serve_latency(server, codes, oracle, what: str) -> dict:
    """Serve requests of 1, 37, 1024 and all rows of ``codes``, each
    checked against ``oracle(rows) -> (name, predictions)`` pairs; returns
    the host-clock latency (ms) per request size and the last predictions."""
    latency = {}
    for rows in (1, 37, 1024, codes.shape[0]):
        t0 = time.perf_counter()
        served = server.classify(codes[:rows])
        latency[rows] = (time.perf_counter() - t0) * 1e3
        for name, want in oracle(rows):
            check(np.array_equal(served, want),
                  f"{what}: served predictions of a {rows}-row request "
                  f"differ from the {name} on {int((served != want).sum())} "
                  f"rows")
    return latency, served


def phase_main_path(problem, out_dir: str) -> dict:
    """The tree path: search -> pareto.json (netlists verified) -> serve,
    counted."""
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
    latency, served = serve_latency(
        server, codes, lambda rows: [("netlist", netlist.simulate(
            circuit, torch.as_tensor(codes[:rows], device=problem.device))
            .cpu().numpy())], "tree")
    acc = float((served == ds.y_test).mean())
    check(abs(acc - art.point_accuracy(idx)) <= 1e-6,
          f"served accuracy {acc} != recorded {art.point_accuracy(idx)}")
    counts = kernels.launch_counts()
    check(all(counts[k] > 0 for k in TREE_KERNELS),
          f"a kernel of the tree path never launched: {counts}")
    log(f"[main] served point {idx} (acc_loss {art.points[idx]['acc_loss']:+.4f}, "
        f"norm_area {art.points[idx]['norm_area']:.4f}) over requests of "
        f"{sorted(latency)} rows == netlist simulation; accuracy {acc:.6f} "
        f"== recorded; latency ms {json.dumps({k: round(v, 3) for k, v in latency.items()})}; "
        f"buckets {server.compiled_buckets()}")
    log(f"[main] launches over search + serve: {counts}")
    return dict(counts=counts, state=result.state)


def phase_qmatmul(problem, rng) -> dict:
    """`qmatmul` against its plain version: exact on integer codes at the
    MLP fitness shape (3090 x 561 @ 561 x 8192, the problem's own codes) and
    at the serving and verify shapes (N=16); within (QMM_RTOL, QMM_ATOL) on
    random float32 and bfloat16 x with int8 weights over [-128, 127] and a
    random scale, at ragged M, K and N. The kernel backend scores the exact
    design (0, 1). Each case is timed beside its bound (operations at the
    int8 rate for integer codes, at the float32 or bf16 rate for float x)
    and, for float32 x,
    beside `torch.mm` on the same inputs (TF32 off; the weight cast to
    float32, times the scale, is made before the timed window)."""
    from repro_torch.families import printed_mlp as pm
    from repro_torch.kernels import qmatmul as qmm

    dev = problem.device
    x = problem.x8f
    b, f = x.shape
    h = problem.n_hidden
    n = POP * h
    w = torch.as_tensor(rng.integers(-8, 8, (f, n)).astype(np.int8),
                        device=dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    cases = [("fitness", x, w, ones, True)]
    for rows in (1, 37, 1024, b):
        cases.append((f"serve/verify M={rows}", x[:rows].contiguous(),
                      w[:, :h].contiguous(), ones[:h].contiguous(), True))
    m_g, k_g, n_g = 300, 777, 515
    xg = torch.as_tensor(rng.standard_normal((m_g, k_g)).astype(np.float32),
                         device=dev)
    wg = torch.as_tensor(rng.integers(-128, 128, (k_g, n_g)).astype(np.int8),
                         device=dev)
    sg = torch.as_tensor(rng.uniform(0.001, 0.1, n_g).astype(np.float32),
                         device=dev)
    cases += [("general float32", xg, wg, sg, False),
              ("general bfloat16", xg.to(torch.bfloat16), wg, sg, False)]

    err = 0.0
    for name, xc, wc, sc, exact in cases:
        got = qmm.qmatmul(xc, wc, sc)
        torch.cuda.synchronize()
        want = qmm.qmatmul_plain(xc, wc, sc)
        e = float((got - want).abs().max())
        where = f"qmatmul {name} {tuple(xc.shape)} @ {tuple(wc.shape)}"
        if exact:
            check(torch.equal(got, want),
                  f"{where} differs from its plain version by {e}")
        else:
            check(torch.allclose(got, want, rtol=QMM_RTOL, atol=QMM_ATOL),
                  f"{where} differs from its plain version by {e} (rtol "
                  f"{QMM_RTOL}, atol {QMM_ATOL})")
        err = max(err, e)
    exact_objs = pm.make_kernel_fitness(problem)(torch.as_tensor(
        problem.exact_genes(), device=dev)[None])
    check(exact_objs.tolist() == [[0.0, 1.0]],
          f"the MLP kernel backend scores the exact design "
          f"{exact_objs.tolist()[0]}, not (0, 1)")

    results = None
    for name, xc, wc, sc, exact in cases:
        m, k = xc.shape
        nn = wc.shape[1]
        ms, plain_ms, text = timed(lambda: qmm.qmatmul(xc, wc, sc),
                                   lambda: qmm.qmatmul_plain(xc, wc, sc),
                                   "qmatmul_kernel", reps=10, plain_reps=5)
        lib_ms, lib_text = None, "torch.mm n/a (no one call takes bf16 x " \
                                 "with float32 weights)"
        if xc.dtype == torch.float32:
            wf = wc.to(torch.float32) * sc
            lib_ms = device_ms(lambda: torch.mm(xc, wf), 10)
            if lib_ms is None:      # the trace held no device activity
                lib_ms = stream_ms(lambda: torch.mm(xc, wf), 10)
            lib_text = (f"torch.mm {lib_ms:.4f} ms (TF32 off, weight cast "
                        f"outside the window)")
        n_ops = 2 * m * k * nn
        n_bytes = m * k * xc.element_size() + k * nn + nn * 4 + m * nn * 4
        # integer codes fit the int8 (u8 x s8) tensor cores exactly; float x
        # needs float32 FMAs, bfloat16 x the bf16 tensor cores
        rate = (INT8_OPS_PER_S if exact else FP32_OPS_PER_S
                if xc.dtype == torch.float32 else BF16_OPS_PER_S)
        bms, by = bound(n_bytes, n_ops, rate)
        log(f"[kernel] qmatmul {name} {m}x{k} @ {k}x{nn}: "
            f"{'equal' if exact else 'within tolerance'}; {text}; "
            f"{lib_text}; bound {bms:.5f} ms ({by}; {n_ops:.4g} ops, "
            f"{n_bytes} bytes)")
        if results is None:
            results = dict(
                name="qmatmul", route="cuda", source=TPU_KERNELS["qmatmul"][0],
                replaces=TPU_KERNELS["qmatmul"][1], launches=0,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)
    log(f"[kernel] qmatmul: the largest difference from the plain version "
        f"over all cases is {err:.3g} (integer cases exact)")
    return results


def phase_mlp_path(problem, dataset: str, pop: int, out_dir: str) -> dict:
    """The printed-MLP path: search -> pareto.json (netlists verified) ->
    serve, counted; then the kernel fitness against the reference on the
    final population."""
    from repro_torch import kernels, search
    from repro_torch.core import netlist
    from repro_torch.core.nsga2 import DOMINATION_KERNEL_MIN_POP
    from repro_torch.datasets import load_dataset
    from repro_torch.families import printed_mlp as pm
    from repro_torch.runtime.classify import ClassifyServer

    tag = f"[mlp {dataset}]"
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = search.run_search(problem, backend="kernel", pop_size=pop,
                               n_generations=GENS, seed=SEED, dataset=dataset,
                               out_dir=out_dir, verify_rtl=True)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    searched = kernels.launch_counts()
    objs = result.pareto_objs
    log(f"{tag} run_search backend=kernel hidden={problem.n_hidden} "
        f"pop={pop} gens={GENS}: search {result.wall_s:.2f} s, pareto.json "
        f"+ verify_rtl {t_run - result.wall_s:.2f} s over {len(objs)} "
        f"points; launches {searched}")
    check(searched["qmatmul"] >= 1 + GENS + len(objs),
          "qmatmul launched fewer than once per generation and pareto point")
    if 2 * pop >= DOMINATION_KERNEL_MIN_POP:
        check(searched["domination_block"] >= 1 + GENS,
              "domination_block launched fewer than once per generation")
    check(bool(((objs[:, 0] <= 0) & (objs[:, 1] <= 1)).any()),
          "no front point matches or dominates the exact design (0, 1)")
    check(np.isfinite(objs).all() and objs.shape[1] == 2,
          "pareto objectives are not finite (K, 2)")
    log(f"{tag} exact accuracy {problem.exact_accuracy:.6f}; front: "
        f"{len(objs)} points, loss [{objs[:, 0].min():+.4f}, "
        f"{objs[:, 0].max():+.4f}], area [{objs[:, 1].min():.4f}, "
        f"{objs[:, 1].max():.4f}]")

    art = search.load_pareto_artifact(str(pathlib.Path(out_dir) /
                                          "pareto.json"))
    check(art.family == "mlp" and art.payload["rtl_verified"] and all(
        p.get("verified") for p in art.points),
        "pareto.json does not record every point as verified")
    idx = art.best_under_loss(0.01)
    if idx is None:
        idx = min(range(len(art.points)),
                  key=lambda i: art.points[i]["acc_loss"])
    server = ClassifyServer.from_artifact(art, point=idx, backend="kernel",
                                          device=problem.device)
    w1, w2 = art.point_design(idx)
    circuit = netlist.build_mlp_circuit(w1, w2, art.shift, art.n_classes)
    ds = load_dataset(dataset)
    codes = server.featurize(ds.x_test)

    def oracle(rows):
        x = torch.as_tensor(codes[:rows], device=problem.device)
        return [("netlist", netlist.simulate(circuit, x).cpu().numpy()),
                ("integer predict", pm.predict_master(w1, w2, art.shift,
                                                      codes[:rows]))]

    latency, served = serve_latency(server, codes, oracle, f"mlp {dataset}")
    acc = float((served == ds.y_test).mean())
    check(abs(acc - art.point_accuracy(idx)) <= 1e-6,
          f"served accuracy {acc} != recorded {art.point_accuracy(idx)}")
    counts = kernels.launch_counts()
    check(counts["qmatmul"] > searched["qmatmul"],
          "serving the MLP point never launched qmatmul")
    log(f"{tag} served point {idx} (acc_loss "
        f"{art.points[idx]['acc_loss']:+.4f}, norm_area "
        f"{art.points[idx]['norm_area']:.4f}) over requests of "
        f"{sorted(latency)} rows == netlist simulation == integer predict; "
        f"accuracy {acc:.6f} == recorded; latency ms "
        f"{json.dumps({k: round(v, 3) for k, v in latency.items()})}")
    log(f"{tag} launches over search + serve: {counts}")

    genes = result.state.genes
    ker = pm.make_kernel_fitness(problem)(genes)
    ref = pm.make_reference_fitness(problem)(genes)
    check(torch.equal(ker, ref), "the MLP kernel fitness differs from the "
          "reference fitness on the final population")
    log(f"{tag} kernel fitness == reference fitness on the final "
        f"population ({genes.shape[0]} chromosomes)")
    return dict(counts=counts, state=result.state)


def phase_breakdown(what: str, fitness, state, n_genes: int, device,
                    kernel: str) -> None:
    """Where one generation's time goes: a whole `make_step` against its
    fitness call (and, from a profiler trace, the device time of the
    fitness kernel ``kernel`` in it) and its survivor selection (sort +
    crowding) on the step's own pool of parents and children, host clock
    around synchronised calls, median of 3; the sort's fronts are its host
    round trips. The device's busy time in a step (every device activity in
    a profiler trace of it) gives the step's device idle share."""
    from repro_torch.core import nsga2

    pop = state.genes.shape[0]
    cfg = nsga2.NSGA2Config(pop_size=pop)
    children = {}

    def fitness_seen(genes):
        children["objs"] = fitness(genes)
        return children["objs"]

    step = nsga2.make_step(fitness_seen, cfg)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)

    def host_ms(fn, reps=3):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    draws = nsga2.draw_step(gen, pop, n_genes, device)
    t_step = host_ms(lambda: step(state, draws))
    busy = device_ms(lambda: step(state, draws), 3)
    t_fit = host_ms(lambda: fitness(state.genes))
    t_kernel = device_ms(lambda: fitness(state.genes), 3, kernel)
    pool = torch.cat([state.objs, children["objs"]])
    t_surv = host_ms(lambda: nsga2.survivors(pool, pop))
    rank, _, _ = nsga2.survivors(pool, pop)
    fronts = int(rank.max()) + 1
    kernel_text = ("not in the trace" if t_kernel is None
                   else f"{t_kernel:.3f} ms")
    busy_text = ("not in the trace" if busy is None else
                 f"{busy:.2f} ms, idle share {1 - busy / t_step:.3f}")
    log(f"[breakdown] {what}: one generation (pop {pop}, pool {2 * pop}): "
        f"step {t_step:.2f} ms = fitness {t_fit:.2f} ms (device time of "
        f"{kernel} in it: {kernel_text}) + survivors {t_surv:.2f} ms "
        f"({fronts} fronts, one host sync each) + operators and draws "
        f"{t_step - t_fit - t_surv:.2f} ms; device busy in a step: "
        f"{busy_text}")


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
    from repro_torch.families import printed_mlp as pm

    t_start = time.perf_counter()
    phase_build()

    t0 = time.perf_counter()
    ds = load_dataset(DATASET)
    tree = train_tree(ds.x_train, ds.y_train, ds.n_classes)
    problem = search.build_problem(to_parallel(tree), ds.x_test, ds.y_test,
                                   device="cuda")
    log(f"[setup] {DATASET} tree: N={problem.n_comparators} "
        f"L={problem.n_leaves} B={problem.x8.shape[0]} "
        f"C={problem.n_classes} F={problem.n_features}, exact accuracy "
        f"{problem.exact_accuracy:.6f} ({time.perf_counter() - t0:.1f} s to "
        f"load, train and build)")
    mlp_problems = {}
    for name, _ in MLP_RUNS:
        t0 = time.perf_counter()
        mp = pm.build_problem(name, n_hidden=MLP_HIDDEN, seed=SEED,
                              device="cuda")
        mlp_problems[name] = mp
        log(f"[setup] {name} mlp: F={mp.n_features} H={mp.n_hidden} "
            f"C={mp.n_classes} B={mp.x8.shape[0]} shift={mp.shift}, exact "
            f"accuracy {mp.exact_accuracy:.6f}, exact area "
            f"{mp.exact_area_mm2:.2f} mm^2 ({time.perf_counter() - t0:.1f} s "
            f"to load, train and build)")

    rng = np.random.default_rng(SEED)
    results = phase_kernels(problem, rng)
    results["qmatmul"] = phase_qmatmul(mlp_problems[MLP_RUNS[0][0]], rng)
    launches = dict.fromkeys(results, 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        tree_path = phase_main_path(problem, out_dir)
    mlp_paths = {}
    for name, pop in MLP_RUNS:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mlp_") as out_dir:
            mlp_paths[name] = phase_mlp_path(mlp_problems[name], name, pop,
                                             out_dir)
    for path in (tree_path, *mlp_paths.values()):
        for name, count in path["counts"].items():
            launches[name] += count
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main paths never launched: {launches}")
    for name, count in launches.items():
        results[name]["launches"] = count

    from repro_torch.search import make_kernel_fitness
    phase_breakdown(f"tree {DATASET}", make_kernel_fitness(problem),
                    tree_path["state"], problem.n_genes, problem.device,
                    "fitness_kernel")
    mp = mlp_problems[MLP_RUNS[0][0]]
    phase_breakdown(f"mlp {MLP_RUNS[0][0]}", pm.make_kernel_fitness(mp),
                    mlp_paths[MLP_RUNS[0][0]]["state"], mp.n_genes,
                    mp.device, "qmatmul_kernel")

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
