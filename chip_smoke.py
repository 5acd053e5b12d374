#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA card

Phases, each of which stops the script with a non-zero exit on failure:

1. Build the five Hopper kernels from `src/repro_torch/csrc/` (one nvcc per
   source, all started together, `sm_90a`) and report nvcc's register and
   spill summary, for `fitness`, `qmatmul` and `flash_attn` by kernel.
2. Hold each kernel to its plain PyTorch version on the card at the main
   paths' shapes (the `har` dataset: a tree of N=588 comparators and L=589
   leaves, and a printed MLP of F=561 features, H=16 hidden and C=6 output
   neurons, over B=3090 test rows): exact equality for the tree kernels
   and for `qmatmul` on the MLP's uint8 codes (the integer tensor-core
   kernel), a stated tolerance for `qmatmul` at a random scale and on
   float inputs (the CUDA-core kernel); report the fitness kernel's rows
   per block and the L2 bytes its path feed reads; hold the non-dominated
   sort (`domination_bits` and the front peel: two launches, checked to
   make no host sync under `torch.cuda.set_sync_debug_mode("error")`) to
   its plain version, the host loop, at pools 256, 1024 and 4096, and
   `tree_infer_scores` at every serving bucket and at N=2048; check that
   each kernel backend scores the exact design
   (0, 1); and time both on the device (a `torch.profiler` trace of
   back-to-back calls) beside the kernel's bound: the larger of its bytes
   over 3.35 TB/s and its operations over the peak rate of their type
   (1979 TOP/s int8 for the tree dataflow and for `qmatmul` on uint8
   codes, 67 TFLOP/s float32 outside the tensor cores for the domination
   compares and `qmatmul` on float32 x, 989 TFLOP/s bf16), and,
   for `qmatmul`, beside the one PyTorch call that computes the same
   function (`torch.mm` on the same values as float32, TF32 off).
3. The tree main path through the user's entry points: train the `har`
   tree, `run_search(backend="kernel", pop_size=512, verify_rtl=True)` into
   a temporary `pareto.json`, then `ClassifyServer.from_artifact` serving
   requests of 1, 37, 1024 and 3090 rows, each checked against the
   gate-level netlist simulation.
4. The printed-MLP main path the same way: `har` at hidden 16, pop 512,
   then `pendigits` at pop 128 (its exact design is far from chance), each
   served request checked against the netlist and the integer predict;
   `qmatmul`'s float kernel must not run on this path.
   Before each path the kernels' launch counters are set to 0 and just
   after they are read; every kernel of the path must have launched, and
   the sort's two kernels (counted under `domination_block`) twice per
   generation.
5. `[forest]`: `--trees 5` on `har` (N=2227 comparators over five trees,
   L=2232, B=3090, C=6; the script fails unless N > 2048): the trees'
   training time; both widened kernels (`fitness_errors` at P=512,
   `tree_infer_scores` at P=1) held to their plain versions, exactly, at
   the forest's block-diagonal super-tree and at a synthetic single tree of
   N=4096, each timed beside its bound with the path product counted tree
   by tree; then the forest path through the user's entry points, counted
   like the others: `run_search(backend="kernel", pop_size=512,
   verify_rtl=True)` and serving at the 1 / 37 / 1024 / 3090-row buckets,
   each request checked against the gate-level netlist.
6. `[flash]`: hold `flash_attention` to its plain version (float32 within
   2e-5; bfloat16 by `row_error`, a row's largest difference over its root
   mean square, within 2^-4) at the LM prefill's shape (llama3.2-3b at
   B=4, S=4096: H=96, Hkv=32, hd=128, bf16) in the model's (B, S, H, hd)
   layout through `flash_attention_bshd`, and in the (H, S, hd) layout in
   float32, with grok's softcap 30, at gemma's MQA with head dim 256 and at
   a ragged S=1000; time it at the main shape beside its plain version, its
   bound (the bf16 tensor-core rate) and `scaled_dot_product_attention`
   (causal, GQA); and check that the model's prefill attention runs nothing
   on the card but the kernel (no layout copies).
7. `[lm]`: the LM serving path at llama3.2-3b's full width (28 layers,
   random bf16 weights from the seed): `generate` of 32 greedy tokens after
   a B=4 x 4096-token prompt (the repo's `train_4k` length; `prefill_32k`
   would need 120 GB of cache on one card), counted: `flash_attention`
   must launch once per layer of the prefill. Decode at position 4096 is
   held to a fresh prefill over the same 4097 tokens, a second `generate`
   must give the same tokens, and prefill and decode times, peak memory and
   the device time of one prefill split into the attention kernel,
   matmuls and the rest are printed.
8. Print where one generation's time goes on each search path (its
   survivor selection run once under sync debug mode "error", its ranks
   held to the host loop's on the same pool).
9. `[chunk]`: on the tree and MLP `har` paths, 8 generations chunked with
   `checkpoint_every=4` (each chunk one captured CUDA graph, its warm-up
   step run under sync debug mode "error") must equal the per-generation
   loop element for element; one generation's host time, device busy time
   and idle share inside a captured chunk beside an eager step's; the
   graphs captured and the dispatches.
10. `[resume]`: 8 tree `har` generations saving every 3; a fresh
   `run_search` resuming from the step-6 save must equal the uninterrupted
   run, the step-8 saves (the CUDA generator's state included) leaf for
   leaf.
11. The kernel list, the card's name and power limit, one JSON line of
   per-kernel results (each row names what it times in `what`), and last
   `{"ok": true, "device": {...}}`.

The search paths run through `run_search`, whose generations are chunks
of captured CUDA graphs; a launch inside a graph counts at every replay.

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
FOREST_TREES = 5       # har --trees 5: N = 2227 comparators, past 2048
WIDE_N, WIDE_POP = 4096, 64   # the synthetic single tree past the old cap
CHUNK = 4              # [chunk]: checkpoint_every, so chunks of 4
RESUME_EVERY = 3       # [resume]: saves at 3, 6 and 8
QMM_RTOL, QMM_ATOL = 1e-5, 1e-3   # qmatmul on float inputs (module doc)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT8_OPS_PER_S = 1979e12       # H100 SXM tensor cores, int8 dense
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM tensor cores, bf16 dense
TPU_KERNELS = {  # kernel -> (port source, the TPU kernel it replaces,
    #                what its row of the kernels line times)
    "fitness_errors": ("src/repro_torch/csrc/fitness.cu",
                       "src/repro/kernels/fitness.py:109",
                       "fitness_correct_counts, tree har: P=512, B=3090, "
                       "N=588, L=589"),
    "domination_block": ("src/repro_torch/csrc/domination.cu",
                         "src/repro/kernels/domination.py:57",
                         "the non-dominated sort of a random pool of 1024, "
                         "M=2: domination_bits + the front peel; launches "
                         "count both, two per sort; the bool slab's own "
                         "times are in the [kernel] domination_block lines"),
    "tree_infer_scores": ("src/repro_torch/csrc/tree_infer.cu",
                          "src/repro/kernels/tree_infer.py:81",
                          "P=1, B=3090 (the tree har verify leg)"),
    "qmatmul": ("src/repro_torch/csrc/qmatmul.cu",
                "src/repro/kernels/qmatmul.py:40",
                "uint8 (3090x561) @ int8 (561x8192), the MLP har fitness"),
    "flash_attention": ("src/repro_torch/csrc/flash_attn.cu",
                        "src/repro/kernels/flash_attn.py:70",
                        "bf16 LM prefill, q (4, 4096, 24, 128), k and v "
                        "(4, 4096, 8, 128), the model's layout"),
}
LM_ARCH = "llama3.2-3b"            # full width; the repo's train_4k length
LM_BATCH, LM_PROMPT, LM_TOKENS = 4, 4096, 32
FLASH_F32_TOL = 2e-5               # tests/test_kernels.py:208-209
# bfloat16: `row_error` (a query row's largest difference over the row's
# root mean square) at most two bf16 ulps of a row's largest element at four
# times its rms; the rows' magnitudes fall to ~0.03 at S=4096, so no one
# absolute tolerance fits them (tests/test_torch_flash.py's module doc)
FLASH_BF16_ROW_TOL = 2.0 ** -4
# decode against a fresh prefill in bfloat16: the two paths round their
# activations at other places (the kernel rounds p to bf16, decode takes a
# float32 softmax; cuBLAS sums a 4-row and a 16k-row product in other
# orders), so logits agree to a few bf16 ulps of their scale, not exactly:
# 0.109 measured on an H100 on logits up to 5.2, against five ulps
# (0.03125 each in [4, 8)) here
LM_LOGIT_ATOL = 0.15


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


def host_ms(fn, reps: int = 3) -> float:
    """Median host-clock ms of ``fn()`` between two synchronisations."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_or_stream_ms(fn, reps: int) -> tuple[float, str]:
    """(ms, source): `device_ms` of every device activity of ``fn``, or
    `stream_ms` where the trace holds no device activity."""
    ms = device_ms(fn, reps)
    if ms is not None:
        return ms, "device time"
    return stream_ms(fn, reps), "stream time"


def timed(kernel_fn, plain_fn, kernel: str | None, reps: int,
          plain_reps: int):
    """(ms, plain_ms, text): the device time of the CUDA kernel named
    ``kernel`` (of every kernel when None) per call of ``kernel_fn`` and the
    device time of every
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


def tree_ops(p: int, b: int, n: int, l: int, c: int,
             nl: int | None = None) -> int:
    """Integer operations of the tree dataflow for p chromosomes on b rows:
    shift and compare per comparator, the path product (2NL; for a forest
    2 sum_k N_k L_k, ``nl``, since a leaf reads only its own tree's
    comparators) and the vote product (2LC) per (chromosome, row)."""
    return p * b * (2 * n + 2 * (n * l if nl is None else nl) + 2 * l * c)


def peel_ops(rank: torch.Tensor) -> int:
    """Word operations the front peel needs for these ranks: for each front
    but the last, an AND and a popcount per unranked column and non-zero
    word of the front's bit set."""
    r = rank.cpu().numpy()
    ops = 0
    for front in range(int(r.max())):
        members = np.flatnonzero(r == front)
        ops += 2 * int((r > front).sum()) * len(np.unique(members // 32))
    return ops


def sync_free(fn, what: str):
    """``fn()`` under `torch.cuda.set_sync_debug_mode("error")`: fails if it
    makes the host wait for the card."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    except RuntimeError as e:
        fail(f"{what} synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")


def ptxas_summary(name: str) -> str:
    from repro_torch.kernels import _build

    text = _build.build_log(name)
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", text)]
    return (f"{len(regs)} kernels, registers max {max(regs, default=0)}, "
            f"spill stores max {max(spills, default=0)} bytes")


def kernel_label(mangled: str) -> str:
    """'name<template ints>' of a mangled kernel name (bf16 marked), or the
    name as given where no `*_kernel` identifier is found in it."""
    i = 0
    while True:
        m = re.compile(r"\d+").search(mangled, i)
        if m is None:
            return mangled
        ident = mangled[m.end():m.end() + int(m.group())]
        if ident.endswith("_kernel"):
            tail = mangled[m.end() + len(ident):].split("Ev", 1)[0]
            args = re.findall(r"Li(\d+)E", tail)
            args = (["bf16"] if "bfloat16" in tail else ["f32"]
                    if tail.startswith("If") else []) + args
            return f"{ident}<{','.join(args)}>" if args else ident
        i = m.end() + len(ident)


def ptxas_kernels(name: str) -> list[str]:
    """'kernel<args>: N registers, M bytes spilled' for every instantiation
    nvcc compiled into library ``name``."""
    from repro_torch.kernels import _build

    rows, fn, spilled = [], None, "?"
    for line in _build.build_log(name).splitlines():
        hit = re.search(r"Compiling entry function '(\w+)'", line)
        if hit:
            fn, spilled = hit.group(1), "?"
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill and fn:
            spilled = spill.group(1)
        regs = re.search(r"Used (\d+) registers", line)
        if regs and fn:
            rows.append(f"{kernel_label(fn)}: {regs.group(1)} registers, "
                        f"{spilled} bytes spilled")
            fn = None
    return rows


def phase_build() -> float:
    from repro_torch.kernels import _build

    seconds = _build.build()
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: {seconds:.1f} s "
        f"for {', '.join(_build.SOURCES)}")
    for name in _build.SOURCES:
        log(f"[build] {name}: {ptxas_summary(name)}")
    for name in ("fitness", "qmatmul", "flash_attn"):
        log(f"[build] {name} by kernel: " + "; ".join(ptxas_kernels(name)))
    return seconds


def phase_kernels(problem, rng) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch import kernels
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
        "fitness_mma_kernel", reps=10, plain_reps=3)
    k_pad, l_pad = fit_ops.x_sel.shape[1], fit_ops.path.shape[0]
    n_ops = tree_ops(POP, b, n, l, c)
    path_bytes = fit_ops.path.numel() + 2 * l_pad * 4
    n_bytes = (b * k_pad + 2 * POP * n * 4 + path_bytes + b * 4 + POP * 4
               + POP * 4)
    bms, by = bound(n_bytes, n_ops, INT8_OPS_PER_S)
    rows = fitness.BLOCK_ROWS
    blocks = POP * -(-b // rows)
    spans = fit_ops.spans.cpu().numpy()
    span_pairs = int(((spans[:, 1] - spans[:, 0]) * fitness.LEAF_TILE).sum())
    l2_bytes = blocks * (span_pairs + 2 * l_pad * 4)
    log(f"[kernel] fitness_errors P={POP} B={b} N={n} L={l} C={c}: equal; "
        f"{text}; bound {bms:.4f} ms ({by}; {n_ops:.4g} int ops, "
        f"{n_bytes} bytes); {n_ops / ms / 1e9:.1f} TOP/s, {ms / bms:.2f}x "
        f"its bound; {rows} rows a block, {blocks} blocks, each reading its "
        f"tiles' spans of the {tuple(fit_ops.path.shape)} path ({span_pairs} "
        f"bytes, {span_pairs / fit_ops.path.numel():.3f} of it), targets and "
        f"classes from L2: {l2_bytes} bytes ({l2_bytes / ms / 1e6:.0f} GB/s)")
    record("fitness_errors", float(err), ms, plain_ms, bms, by)

    # domination_block: the GA pool (2P rows) against itself, and a slab
    errs = []
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

    # the sort on the card (relation bits + front peel, two launches, no host
    # sync) against its plain version, the host loop, at the MLP pendigits
    # pool, the GA pool and a pool whose relation lives in L2
    main = None
    for p in (256, 2 * POP, 4096):
        objs = torch.as_tensor((rng.integers(0, 64, (p, 2)) / 63)
                               .astype(np.float32), device=dev)
        rel, counts = domination.domination_bits(objs)
        torch.cuda.synchronize()
        want_rel, want_counts = domination.domination_bits_plain(objs)
        check(torch.equal(rel, want_rel) and torch.equal(counts, want_counts),
              f"domination_bits at pool {p} differs from its plain version")
        launches = kernels.launch_counts()["domination_block"]
        got = sync_free(lambda: domination.non_dominated_rank(objs),
                        f"the sort at pool {p}")
        torch.cuda.synchronize()
        check(kernels.launch_counts()["domination_block"] == launches + 2,
              f"the sort at pool {p} did not make exactly two launches")
        want = domination.non_dominated_rank_plain(objs)
        err = int((got - want).abs().max())
        check(err == 0, f"the sort at pool {p} differs from the host loop by "
              f"{err} ranks")
        errs.append(err)
        ms, plain_ms, text = timed(
            lambda: domination.non_dominated_rank(objs),
            lambda: domination.non_dominated_rank_plain(objs),
            None, reps=20, plain_reps=3)
        n_ops = 3 * 2 * p * p + peel_ops(got)
        n_bytes = p * 2 * 4 + p * 4
        bms, by = bound(n_bytes, n_ops, FP32_OPS_PER_S)
        fronts = int(got.max()) + 1
        log(f"[kernel] sort (domination_bits + peel) pool {p} M=2, {fronts} "
            f"fronts: ranks equal the host loop, 2 launches, no host sync; "
            f"{text}; bound {bms:.5f} ms ({by}; {n_ops} compares and "
            f"popcounts, {n_bytes} bytes)")
        if p == 2 * POP:
            main = (ms, plain_ms, bms, by)
    record("domination_block", float(max(errs)), *main)

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
    # the other design for the P = 1 legs: the fitness kernel's int8
    # mma.sync path product, timed at P = 1 on the verify leg's rows
    one = genes_t[1:2]
    shift_1, thr_1, _, cap_1 = ops.decode_population_full(problem.threshold,
                                                          one)
    mma_ms = device_ms(lambda: fitness.fitness_correct_counts(
        fit_ops, shift_1, thr_1, cap_1), 20, "fitness_mma_kernel")
    log(f"[kernel] the int8 path product at P=1 (fitness_mma_kernel on the "
        f"same {b} rows, correct counts only): "
        + ("not in the trace" if mma_ms is None else
           f"{mma_ms:.4f} ms device time, against tree_infer_scores' "
           f"{main[0]:.4f} ms for the votes"))
    # the widest masks the kernel takes: N = 2048 comparators, 2049 leaves
    # of eight comparators each, on the har rows
    n_w, l_w = 2048, 2049
    path = np.zeros((l_w, n_w), np.int8)
    for i in range(l_w):
        path[i, rng.choice(n_w, 8, replace=False)] = rng.choice([-1, 1], 8)
    ops_w = ops.prepare_operands(
        rng.integers(0, n_feat, n_w), path, (path != 0).sum(1),
        (path == -1).sum(1), rng.integers(0, c, l_w), c, n_feat, device=dev)
    bits = rng.integers(1, 9, (2, n_w))
    shift_w = torch.as_tensor(8 - bits, dtype=torch.int32, device=dev)
    thr_w = torch.as_tensor(rng.integers(0, 256, (2, n_w)) % (1 << bits),
                            dtype=torch.int32, device=dev)
    got = tree_infer.tree_infer_scores(problem.x8, ops_w, shift_w, thr_w)
    torch.cuda.synchronize()
    want = tree_infer.tree_infer_scores_plain(problem.x8, ops_w, shift_w,
                                              thr_w)
    err = int((got - want).abs().max())
    check(err == 0 and int(want.sum()) > 0, f"tree_infer_scores at N={n_w} "
          f"differs from its plain version by {err}")
    errs.append(err)
    log(f"[kernel] tree_infer_scores P=2 B={b} N={n_w} L={l_w}: equal "
        f"({int(want.sum())} votes)")
    record("tree_infer_scores", float(max(errs)), *main)
    return results


TREE_KERNELS = ("fitness_errors", "domination_block", "tree_infer_scores")


def check_sort_launches(counts: dict, gens: int) -> None:
    """In ``counts`` (`kernels.launch_counts()` over one search), every
    generation and the initial population sorted their pool on the card:
    `domination_block` counts the sort's two launches (the relation and the
    peel), so at least 2 (1 + ``gens``), two per sort."""
    n = counts["domination_block"]
    check(n % 2 == 0 and n >= 2 * (1 + gens),
          f"the sort launched {n} times over {gens} generations, not twice "
          f"per sort")


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
        f"{result.n_dispatches} device dispatches; launches {searched}")
    check(searched["fitness_errors"] >= 1 + GENS,
          "fitness_errors launched fewer than once per generation")
    check_sort_launches(searched, GENS)
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
    """`qmatmul` against its plain version. On uint8 codes (the integer
    tensor-core kernel): exact at the MLP fitness shape (3090 x 561 @ 561 x
    8192, the problem's own codes buffer) and at the serving and verify
    shapes (N=16, M = 1, 37, 1024, 3090), and within (QMM_RTOL, QMM_ATOL)
    at a ragged shape with int8 weights over [-128, 127] and a random
    scale. On random float32 and bfloat16 x (the CUDA-core kernel) within
    the same tolerance at the ragged shape. The kernel backend scores the
    exact design (0, 1). Each case is timed beside its bound (operations at
    the int8 rate for uint8 x, at the float32 or bf16 rate for float x)
    and, for uint8 and float32 x, beside `torch.mm` on the same values as
    float32 (TF32 off; the casts, and the weight times the scale, are made
    before the timed window)."""
    from repro_torch.families import printed_mlp as pm
    from repro_torch.kernels import qmatmul as qmm

    dev = problem.device
    x = problem.x8u
    b, f = x.shape
    h = problem.n_hidden
    n = POP * h
    w = torch.as_tensor(rng.integers(-8, 8, (f, n)).astype(np.int8),
                        device=dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    cases = [("fitness uint8", x, w, ones, True)]
    for rows in (1, 37, 1024, b):
        cases.append((f"serve/verify uint8 M={rows}", x[:rows],
                      w[:, :h].contiguous(), ones[:h].contiguous(), True))
    m_g, k_g, n_g = 300, 777, 515
    xg = torch.as_tensor(rng.standard_normal((m_g, k_g)).astype(np.float32),
                         device=dev)
    xu = torch.as_tensor(rng.integers(0, 256, (m_g, k_g)).astype(np.uint8),
                         device=dev)
    wg = torch.as_tensor(rng.integers(-128, 128, (k_g, n_g)).astype(np.int8),
                         device=dev)
    sg = torch.as_tensor(rng.uniform(0.001, 0.1, n_g).astype(np.float32),
                         device=dev)
    cases += [("general uint8", xu, wg, sg, False),
              ("general float32", xg, wg, sg, False),
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
                                   "qmatmul", reps=20, plain_reps=5)
        lib_ms, lib_text = None, "torch.mm n/a (no one call takes bf16 x " \
                                 "with float32 weights)"
        if xc.dtype != torch.bfloat16:
            xf = xc.to(torch.float32)
            wf = wc.to(torch.float32) * sc
            lib_ms, _ = device_or_stream_ms(lambda: torch.mm(xf, wf), 20)
            lib_text = (f"torch.mm {lib_ms:.4f} ms (TF32 off, float32 "
                        f"operands made outside the window)")
        n_ops = 2 * m * k * nn
        n_bytes = m * k * xc.element_size() + k * nn + nn * 4 + m * nn * 4
        # codes fit the int8 (u8 x s8) tensor cores exactly; float32 x needs
        # float32 FMAs, bfloat16 x the bf16 tensor cores
        rate = (INT8_OPS_PER_S if xc.dtype == torch.uint8 else FP32_OPS_PER_S
                if xc.dtype == torch.float32 else BF16_OPS_PER_S)
        bms, by = bound(n_bytes, n_ops, rate)
        lib_vs = f", {ms / lib_ms:.2f}x torch.mm" if lib_ms else ""
        log(f"[kernel] qmatmul {name} {m}x{k} @ {k}x{nn}: "
            f"{'equal' if exact else 'within tolerance'}; {text}; "
            f"{lib_text}; bound {bms:.5f} ms ({by}; {n_ops:.4g} ops, "
            f"{n_bytes} bytes); {ms / bms:.2f}x its bound{lib_vs}")
        if results is None:
            results = dict(
                name="qmatmul", route="cuda", source=TPU_KERNELS["qmatmul"][0],
                replaces=TPU_KERNELS["qmatmul"][1], launches=0,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)
    log(f"[kernel] qmatmul: the largest difference from the plain version "
        f"over all cases is {err:.3g} (fitness, serve and verify cases "
        f"exact)")
    return results


def phase_mlp_path(problem, dataset: str, pop: int, out_dir: str) -> dict:
    """The printed-MLP path: search -> pareto.json (netlists verified) ->
    serve, counted; then the kernel fitness against the reference on the
    final population."""
    from repro_torch import kernels, search
    from repro_torch.core import netlist
    from repro_torch.datasets import load_dataset
    from repro_torch.families import printed_mlp as pm
    from repro_torch.runtime.classify import ClassifyServer

    from repro_torch.kernels import qmatmul as qmm

    tag = f"[mlp {dataset}]"
    float_launches = qmm.qmatmul.float_launches
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
    check_sort_launches(searched, GENS)
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
    check(qmm.qmatmul.float_launches == float_launches,
          "the MLP path ran qmatmul's float kernel, not the integer one")
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
    around synchronised calls, median of 3, with the device time of the
    sort's two kernels (relation and front peel) on that pool; survivors
    must run without a host sync, and its ranks must equal the host loop's
    on that pool. The device's busy time in a step (every
    device activity in a profiler trace of it) gives the step's device idle
    share."""
    from repro_torch.core import nsga2
    from repro_torch.kernels import domination

    pop = state.genes.shape[0]
    cfg = nsga2.NSGA2Config(pop_size=pop)
    children = {}

    def fitness_seen(genes):
        children["objs"] = fitness(genes)
        return children["objs"]

    step = nsga2.make_step(fitness_seen, cfg)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)

    draws = nsga2.draw_step(gen, pop, n_genes, device)
    t_step = host_ms(lambda: step(state, draws))
    busy = device_ms(lambda: step(state, draws), 3)
    t_fit = host_ms(lambda: fitness(state.genes))
    t_kernel = device_ms(lambda: fitness(state.genes), 3, kernel)
    pool = torch.cat([state.objs, children["objs"]])
    rank, _, _ = sync_free(lambda: nsga2.survivors(pool, pop),
                           f"{what}: survivors")
    check(torch.equal(rank, domination.non_dominated_rank_plain(pool)),
          f"{what}: the card's ranks of the search pool differ from the "
          f"host loop's")
    t_surv = host_ms(lambda: nsga2.survivors(pool, pop))
    t_sort = device_ms(lambda: nsga2.non_dominated_sort(pool), 10)
    fronts = int(rank.max()) + 1
    sort_text = ("not in the trace" if t_sort is None
                 else f"{t_sort:.4f} ms")
    kernel_text = ("not in the trace" if t_kernel is None
                   else f"{t_kernel:.3f} ms")
    busy_text = ("not in the trace" if busy is None else
                 f"{busy:.2f} ms, idle share {1 - busy / t_step:.3f}")
    log(f"[breakdown] {what}: one generation (pop {pop}, pool {2 * pop}): "
        f"step {t_step:.2f} ms = fitness {t_fit:.2f} ms (device time of "
        f"{kernel} in it: {kernel_text}) + survivors {t_surv:.2f} ms "
        f"({fronts} fronts peeled on the card, no host sync; device time "
        f"of the sort's two kernels {sort_text}) + operators and draws "
        f"{t_step - t_fit - t_surv:.2f} ms; device busy in a step: "
        f"{busy_text}")


def forest_nl(ptrees) -> int:
    """sum_k N_k L_k: the path product's multiply-adds per row of a forest
    (N L for one tree)."""
    return sum(pt.n_comparators * pt.n_leaves for pt in ptrees)


def random_chromosomes(rng, p: int, n: int, dev):
    """(shift, thr, cap) of p random chromosomes over n comparators, both
    vote caps."""
    from repro_torch.core import quant

    bits = rng.integers(1, 9, (p, n))
    shift = torch.as_tensor(8 - bits, dtype=torch.int32, device=dev)
    thr = torch.as_tensor(rng.integers(0, 256, (p, n)) % (1 << bits),
                          dtype=torch.int32, device=dev)
    cap = torch.as_tensor(np.where(rng.random(p) < 0.5, 1,
                                   quant.NO_VOTE_CAP), dtype=torch.int32,
                          device=dev)
    return shift, thr, cap


def phase_wide_kernels(what: str, ptrees, x8: torch.Tensor, y, c: int,
                       fit_pop: int, rng) -> None:
    """Both widened kernels against their plain versions at one wide
    layout (the forest's block-diagonal super-tree, or a single wide tree):
    `fitness_correct_counts` at P = ``fit_pop`` over the rows of ``x8`` and
    `tree_infer_scores` at P = 1 (the verify leg), exact, each timed beside
    its bound with the path product counted tree by tree."""
    from repro_torch.core.tree import concatenate_ptrees
    from repro_torch.kernels import fitness, ops, tree_infer

    dev = x8.device
    arrays = concatenate_ptrees(ptrees)
    n, l = arrays["path"].shape[1], arrays["path"].shape[0]
    b, n_feat = x8.shape
    nl = forest_nl(ptrees)
    feature = torch.as_tensor(arrays["feature"], device=dev).long()
    fit_ops = ops.prepare_fitness_operands(
        x8[:, feature], y, arrays["path"], arrays["path_len"],
        arrays["n_neg"], arrays["leaf_class"], c)
    shift, thr, cap = random_chromosomes(rng, fit_pop, n, dev)
    got = fitness.fitness_correct_counts(fit_ops, shift, thr, cap)
    torch.cuda.synchronize()
    want = fitness.fitness_correct_counts_plain(fit_ops, shift, thr, cap)
    err = int((got.long() - want.long()).abs().max())
    check(err == 0 and int(want.sum()) > 0,
          f"fitness_errors at {what} differs from its plain version by {err}")
    ms, plain_ms, text = timed(
        lambda: fitness.fitness_correct_counts(fit_ops, shift, thr, cap),
        lambda: fitness.fitness_correct_counts_plain(fit_ops, shift, thr, cap),
        "fitness_mma_kernel", reps=10, plain_reps=2)
    spans = fit_ops.spans.cpu().numpy()
    span_work = int(((spans[:, 1] - spans[:, 0]) * fitness.LEAF_TILE).sum())
    n_ops = tree_ops(fit_pop, b, n, l, c, nl)
    n_bytes = (b * fit_ops.x_sel.shape[1] + 2 * fit_pop * n * 4
               + fit_ops.path.numel() + 2 * fit_ops.path.shape[0] * 4
               + b * 4 + 2 * fit_pop * 4)
    bms, by = bound(n_bytes, n_ops, INT8_OPS_PER_S)
    log(f"[forest] fitness_errors {what} P={fit_pop} B={b} N={n} L={l} C={c}:"
        f" equal; {text}; bound {bms:.4f} ms ({by}; {n_ops:.4g} int ops with "
        f"the path product tree by tree, sum N_k L_k = {nl}, dense N L = "
        f"{n * l}; {n_bytes} bytes); {n_ops / ms / 1e9:.1f} TOP/s, "
        f"{ms / bms:.2f}x its bound; chunk {fit_ops.chunk} comparators, the "
        f"tiles' spans {span_work} leaf-comparator pairs "
        f"({span_work / (n * l):.3f} of the dense product)")
    operands = ops.prepare_operands(
        arrays["feature"], arrays["path"], arrays["path_len"],
        arrays["n_neg"], arrays["leaf_class"], c, n_feat, device=dev)
    s1, t1 = shift[:1].contiguous(), thr[:1].contiguous()
    got = tree_infer.tree_infer_scores(x8, operands, s1, t1)
    torch.cuda.synchronize()
    want = tree_infer.tree_infer_scores_plain(x8, operands, s1, t1)
    err = int((got - want).abs().max())
    check(err == 0 and int(want.sum()) > 0,
          f"tree_infer_scores at {what} differs from its plain version by "
          f"{err}")
    ms, plain_ms, text = timed(
        lambda: tree_infer.tree_infer_scores(x8, operands, s1, t1),
        lambda: tree_infer.tree_infer_scores_plain(x8, operands, s1, t1),
        "tree_infer_kernel", reps=20, plain_reps=5)
    n_ops = tree_ops(1, b, n, l, c, nl)
    n_bytes = (b * n_feat * 4 + n * 4 + 2 * n * 4
               + 2 * operands.pos.numel() * 4 + 3 * l * 4 + b * c * 4)
    bms, by = bound(n_bytes, n_ops, INT8_OPS_PER_S)
    log(f"[forest] tree_infer_scores {what} P=1 B={b}: equal; {text}; bound "
        f"{bms:.5f} ms ({by}; {n_ops:.4g} int ops, {n_bytes} bytes); "
        f"{ms / bms:.1f}x its bound; masks of {operands.nwp} words x "
        f"{operands.n_seg} segment(s) a leaf, {operands.d_words} decision "
        f"words a sample")


def phase_forest(rng, out_dir: str, device="cuda") -> dict:
    """`--trees 5` on har: train the forest (timed), hold both widened
    kernels to their plain versions at its super-tree and at a synthetic
    single tree of 4096 comparators, then the forest path through the
    user's entry points, counted: `run_search(backend="kernel")` with
    `verify_rtl` into a `pareto.json`, and serving at the 1 / 37 / 1024 /
    3090-row buckets against the netlist."""
    from repro_torch import kernels, search
    from repro_torch.core import netlist
    from repro_torch.core.forest import train_forest
    from repro_torch.core.tree import random_tree, to_parallel
    from repro_torch.datasets import load_dataset
    from repro_torch.runtime.classify import ClassifyServer

    ds = load_dataset(DATASET)
    t0 = time.perf_counter()
    forest = train_forest(ds.x_train, ds.y_train, ds.n_classes,
                          n_trees=FOREST_TREES)
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    problem = search.build_forest_problem(forest, ds.x_test, ds.y_test,
                                          device=device)
    t_build = time.perf_counter() - t0
    n, l = problem.n_comparators, problem.n_leaves
    widest = max(problem.tree_comparators)
    log(f"[forest] {DATASET} --trees {FOREST_TREES}: N={n} L={l} "
        f"B={problem.x8.shape[0]} C={problem.n_classes}; trees' comparators "
        f"{list(problem.tree_comparators)} (widest {widest}), leaves "
        f"{list(problem.tree_leaves)}; exact accuracy "
        f"{problem.exact_accuracy:.6f}, exact area "
        f"{problem.exact_area_mm2:.2f} mm^2 (vote adder "
        f"{problem.vote_units_exact} / {problem.vote_units_approx} quanta "
        f"exact / approximate); training {t_train:.1f} s, problem "
        f"{t_build:.1f} s")
    check(n > 2048, f"the forest has N={n} comparators, not past the old "
          f"2048 cap")
    c = problem.n_classes
    y = problem.y.cpu().numpy()
    phase_wide_kernels(f"forest[{FOREST_TREES}]", forest.ptrees, problem.x8,
                       y, c, POP, rng)
    wide = to_parallel(random_tree(rng, WIDE_N, problem.n_features, c))
    phase_wide_kernels(f"synthetic tree N={WIDE_N}", [wide], problem.x8, y, c,
                       WIDE_POP, rng)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = search.run_search(problem, backend="kernel", pop_size=POP,
                               n_generations=GENS, seed=SEED,
                               dataset=DATASET, out_dir=out_dir,
                               verify_rtl=True)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    searched = kernels.launch_counts()
    objs = result.pareto_objs
    log(f"[forest] run_search backend=kernel pop={POP} gens={GENS}: search "
        f"{result.wall_s:.2f} s, pareto.json + verify_rtl "
        f"{t_run - result.wall_s:.2f} s over {len(objs)} points; "
        f"{result.n_dispatches} device dispatches; launches {searched}")
    check(searched["fitness_errors"] >= 1 + GENS,
          "fitness_errors launched fewer than once per generation")
    check_sort_launches(searched, GENS)
    check(bool(((objs[:, 0] <= 0) & (objs[:, 1] <= 1)).any()),
          "no front point matches or dominates the exact design (0, 1)")
    check(np.isfinite(objs).all() and objs.shape[1] == 2,
          "pareto objectives are not finite (K, 2)")
    art = search.load_pareto_artifact(str(pathlib.Path(out_dir) /
                                          "pareto.json"))
    check(art.n_trees == FOREST_TREES and art.payload["rtl_verified"]
          and all(p.get("verified") for p in art.points),
          "the forest's pareto.json does not record every point as verified")
    log(f"[forest] front: {len(objs)} points, loss "
        f"[{objs[:, 0].min():+.4f}, {objs[:, 0].max():+.4f}], area "
        f"[{objs[:, 1].min():.4f}, {objs[:, 1].max():.4f}]; every point's "
        f"netlist == predict_votes == tree_infer_scores over "
        f"{problem.x8.shape[0]} rows")
    idx = art.best_under_loss(0.01)
    if idx is None:
        idx = min(range(len(art.points)),
                  key=lambda i: art.points[i]["acc_loss"])
    server = ClassifyServer.from_artifact(art, point=idx, backend="kernel",
                                          device=device)
    bits, t_int, trunc, vote_adder = art.point_design(idx)
    circuit = netlist.build_circuit(art.ptrees(), bits, t_int, art.n_classes,
                                    trunc=trunc, vote_adder=vote_adder)
    codes = server.featurize(ds.x_test)
    latency, served = serve_latency(
        server, codes, lambda rows: [("netlist", netlist.simulate(
            circuit, torch.as_tensor(codes[:rows], device=device))
            .cpu().numpy())], "forest")
    acc = float((served == ds.y_test).mean())
    check(abs(acc - art.point_accuracy(idx)) <= 1e-6,
          f"served accuracy {acc} != recorded {art.point_accuracy(idx)}")
    counts = kernels.launch_counts()
    check(all(counts[k] > 0 for k in TREE_KERNELS),
          f"a kernel of the forest path never launched: {counts}")
    log(f"[forest] served point {idx} ({vote_adder} vote adder, acc_loss "
        f"{art.points[idx]['acc_loss']:+.4f}, norm_area "
        f"{art.points[idx]['norm_area']:.4f}) over requests of "
        f"{sorted(latency)} rows == netlist simulation; accuracy {acc:.6f} "
        f"== recorded; latency ms "
        f"{json.dumps({k: round(v, 3) for k, v in latency.items()})}")
    log(f"[forest] launches over search + serve: {counts}")
    return dict(counts=counts)


def eager_run(problem, fitness, pop: int, gens: int, seed: int):
    """The per-generation loop `run_search` replaced: the same initial
    population and generator, then `make_step` once per generation."""
    from repro_torch.core import nsga2

    dev = problem.device
    cfg = nsga2.NSGA2Config(pop_size=pop)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = nsga2.init_state(fitness, cfg, nsga2.draw_init(
        gen, pop, problem.n_genes, 1, dev), seed_genes=problem.exact_genes())
    step = nsga2.make_step(fitness, cfg)
    for _ in range(gens):
        state = step(state, nsga2.draw_step(gen, pop, problem.n_genes, dev))
    return state, gen


def same_state(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("genes", "objs", "rank", "crowd"))


def phase_chunk(what: str, problem, fitness, out_dir: str) -> None:
    """A chunked run (`run_search`, ``checkpoint_every`` = CHUNK: one CUDA
    graph a chunk) equals the per-generation loop element for element; then
    one generation's time inside a captured chunk beside an eager step
    (draws included in both), host clock around synchronised calls, median
    of 3, with the device's busy time from a profiler trace and the idle
    share; the graphs captured and the dispatches."""
    from repro_torch import search
    from repro_torch.core import nsga2

    captures = nsga2.make_chunk.captures
    result = search.run_search(problem, backend="kernel", pop_size=POP,
                               n_generations=GENS, seed=SEED,
                               out_dir=out_dir, checkpoint_every=CHUNK)
    torch.cuda.synchronize()
    graphs = nsga2.make_chunk.captures - captures
    eager, _ = eager_run(problem, fitness, POP, GENS, SEED)
    check(same_state(result.state, eager),
          f"{what}: the chunked run differs from the per-generation loop")
    check(result.n_dispatches == 1 + -(-GENS // CHUNK),
          f"{what}: {result.n_dispatches} dispatches for {GENS} generations "
          f"in chunks of {CHUNK}")

    state = result.state
    dev = problem.device
    cfg = nsga2.NSGA2Config(pop_size=POP)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    step = nsga2.make_step(fitness, cfg)
    chunk = nsga2.make_chunk(fitness, cfg, CHUNK)
    chunk(state, gen)                        # capture

    def eager_step():
        return step(state, nsga2.draw_step(gen, POP, problem.n_genes, dev))

    t_eager = host_ms(eager_step)
    busy_eager = device_ms(eager_step, 3)
    t_chunk = host_ms(lambda: chunk(state, gen)) / CHUNK
    busy_chunk = device_ms(lambda: chunk(state, gen), 3)

    def busy_text(busy, t):
        if busy is None:
            return "not in the trace"
        return f"{busy:.2f} ms, idle share {1 - busy / t:.3f}"

    log(f"[chunk] {what}: {GENS} generations in chunks of {CHUNK} == the "
        f"per-generation loop (genes, objs, rank, crowd); "
        f"{result.n_dispatches} device dispatches, {graphs} CUDA graphs "
        f"captured")
    log(f"[chunk] {what}: one generation (pop {POP}, draws included): eager "
        f"step {t_eager:.2f} ms, device busy "
        f"{busy_text(busy_eager, t_eager)}; in a captured chunk of {CHUNK} "
        f"{t_chunk:.2f} ms, device busy "
        + busy_text(None if busy_chunk is None else busy_chunk / CHUNK,
                    t_chunk))


def phase_resume(problem, root: str) -> None:
    """8 generations with saves every 3 (3, 6, 8); a fresh `run_search` that
    resumes from the step-6 save must end equal to the uninterrupted run:
    the population, ranks and crowding, and every leaf of the step-8 save,
    the CUDA generator's state included."""
    import shutil

    from repro_torch import search

    a, b = pathlib.Path(root) / "full", pathlib.Path(root) / "resumed"
    full = search.run_search(problem, backend="kernel", pop_size=POP,
                             n_generations=GENS, seed=SEED, out_dir=str(a),
                             checkpoint_every=RESUME_EVERY)
    saved = sorted(p.name for p in (a / "ckpt").iterdir())
    check(saved == ["ckpt_00000003", "ckpt_00000006", "ckpt_00000008"],
          f"saves {saved}, not at 3, 6 and 8")
    (b / "ckpt").mkdir(parents=True)
    shutil.copytree(a / "ckpt" / "ckpt_00000006", b / "ckpt" / "ckpt_00000006")
    resumed = search.run_search(problem, backend="kernel", pop_size=POP,
                                n_generations=GENS, seed=SEED,
                                out_dir=str(b), checkpoint_every=RESUME_EVERY,
                                resume=True)
    check(same_state(full.state, resumed.state),
          "the resumed run differs from the uninterrupted one")
    with np.load(a / "ckpt" / "ckpt_00000008" / "arrays.npz") as x, \
            np.load(b / "ckpt" / "ckpt_00000008" / "arrays.npz") as y:
        check(sorted(x.files) == sorted(y.files) and all(
            np.array_equal(x[k], y[k]) for k in x.files),
            "the step-8 saves differ (population or generator state)")
        rng_bytes = x["4"].size
    log(f"[resume] {DATASET} tree pop {POP}: {GENS} generations saving every "
        f"{RESUME_EVERY} (steps {[int(s[5:]) for s in saved]}); resumed from "
        f"step 6 in a fresh run_search ({resumed.n_dispatches} dispatch, "
        f"{resumed.n_evaluations} evaluations) == the uninterrupted run, and "
        f"the step-8 saves are equal leaf for leaf (genes, objs, rank, "
        f"crowd, the {rng_bytes}-byte CUDA generator state, generation)")


def attention_pairs(sq: int, skv: int) -> int:
    """(query, key) pairs a causal mask keeps: query i sees keys 0..i."""
    i = np.arange(sq)
    return int(np.minimum(i + 1, skv).sum())


def phase_flash(rng) -> dict:
    """`flash_attention` against its plain version on the card: the LM
    prefill's shape (llama3.2-3b at B=4, S=4096) in the model's (B, S, H,
    hd) layout through `flash_attention_bshd`, then float32, grok's softcap,
    gemma's MQA with head dim 256 and a ragged S in the (H, S, hd) layout;
    timed at the main shape beside its bound and
    `scaled_dot_product_attention` (causal, GQA, the one PyTorch call that
    computes the same function without a softcap); and the device
    activities other than the kernel in the model's prefill attention."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.models import attention

    cfg = get_config(LM_ARCH)
    b, kv, g = LM_BATCH, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    cases = [  # (name, H, Hkv, S, hd, dtype, softcap)
        ("main", b * cfg.n_heads, b * kv, LM_PROMPT, cfg.head_dim,
         torch.bfloat16, 0.0),
        ("float32", 8, 4, 512, 64, torch.float32, 0.0),
        ("softcap 30", 48, 8, 1024, 128, torch.bfloat16, 30.0),
        ("MQA hd 256", 8, 1, 2048, 256, torch.bfloat16, 0.0),
        ("ragged", 24, 8, 1000, 128, torch.bfloat16, 0.0),
    ]
    err, result = 0.0, None
    for name, h, hkv, s, hd, dtype, cap in cases:
        if name == "main":   # (B, S, heads, hd), as the model holds them
            q, k, v = (torch.as_tensor(rng.standard_normal(
                (b, s, n // b, hd), dtype=np.float32), device="cuda")
                .to(dtype) for n in (h, hkv, hkv))
            got = fa.flash_attention_bshd(q, k, v, softcap=cap)
            torch.cuda.synchronize()
            want = fa.flash_attention_bshd_plain(q, k, v, softcap=cap)
        else:
            q, k, v = (torch.as_tensor(rng.standard_normal(
                (n, s, hd), dtype=np.float32), device="cuda")
                .to(dtype) for n in (h, hkv, hkv))
            got = fa.flash_attention(q, k, v, group=h // hkv, softcap=cap)
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(q, k, v, group=h // hkv,
                                            softcap=cap)
        e = float((got.float() - want.float()).abs().max())
        where = (f"flash_attention {name} H={h} Hkv={hkv} S={s} hd={hd} "
                 f"{str(dtype)[6:]} softcap={cap}")
        check(bool(torch.isfinite(got).all()), f"{where}: non-finite output")
        if dtype == torch.float32:
            check(torch.allclose(got, want, rtol=FLASH_F32_TOL,
                                 atol=FLASH_F32_TOL), f"{where} differs "
                  f"from its plain version by {e} (tol {FLASH_F32_TOL})")
            how = f"within {FLASH_F32_TOL} of the plain version"
        else:
            row_err = fa.row_error(got, want)
            check(row_err <= FLASH_BF16_ROW_TOL, f"{where}: row error "
                  f"{row_err} against its plain version (limit "
                  f"{FLASH_BF16_ROW_TOL})")
            late = float(want[:, s // 2:].float().abs().median())
            how = (f"row error {row_err:.4f} against the plain version "
                   f"(limit {FLASH_BF16_ROW_TOL}; median |out| in the second "
                   f"half of the rows {late:.4f})")
        err = max(err, e)
        log(f"[flash] {where}: {how}; largest difference {e:.3g}")
        if name != "main":
            continue
        del want
        ms, plain_ms, text = timed(
            lambda: fa.flash_attention_bshd(q, k, v),
            lambda: fa.flash_attention_bshd_plain(q, k, v),
            "flash_attn", reps=20, plain_reps=2)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)

        lib_ms, lib_how = device_or_stream_ms(sdpa, 20)
        lib_err = float((sdpa().transpose(1, 2).float() - got.float())
                        .abs().max())
        n_ops = 4 * attention_pairs(s, s) * hd * h
        n_bytes = (2 * h + 2 * hkv) * s * hd * q.element_size()
        bms, by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
        log(f"[flash] main shape, model layout: {text}; "
            f"scaled_dot_product_attention {lib_ms:.4f} ms {lib_how} "
            f"(differs from the kernel by {lib_err:.3g}); bound {bms:.4f} "
            f"ms ({by}; {n_ops:.4g} FLOPs at 989 TFLOP/s bf16, {n_bytes} "
            f"bytes); kernel at {n_ops / ms / 1e9:.1f} TFLOP/s, "
            f"{ms / lib_ms:.2f}x SDPA, {ms / bms:.2f}x its bound")
        # what else the model's prefill attention runs on the card: the
        # kernel reads q, k, v and writes its output in the model's layout
        qg = q.view(b, s, kv, g, hd)
        attention.chunked_prefill_attention(qg, k, v)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            attention.chunked_prefill_attention(qg, k, v)
            torch.cuda.synchronize()
        others = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "flash_attn" not in e.name]
        other_ms = sum(e.time_range.elapsed_us() for e in others) / 1e3
        log(f"[flash] device activities beside the kernel in one "
            f"chunked_prefill_attention at the main shape: {len(others)} "
            f"({other_ms:.4f} ms){': ' if others else ''}"
            f"{', '.join(sorted({e.name[:60] for e in others}))}")
        check(not others, "the model's prefill attention copies around "
              "the kernel")
        result = dict(
            name="flash_attention", route="cuda",
            source=TPU_KERNELS["flash_attention"][0],
            replaces=TPU_KERNELS["flash_attention"][1], launches=0,
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=lib_ms)
        del q, k, v, got, qt, kt, vt, qg
    result["max_abs_err"] = err
    log(f"[flash] the largest difference from the plain version over all "
        f"cases is {err:.3g}")
    return result


def phase_lm() -> dict:
    """The LM serving path at llama3.2-3b width: random bf16 parameters and a
    B=4 x 4096-token prompt from the seed, greedy `generate` of 32 tokens,
    counted (one `flash_attention` launch per layer of the prefill); decode
    against a fresh prefill over the same tokens; a second `generate`
    giving the same tokens; prefill and decode times, peak memory and
    where one prefill's device time goes."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import attention, lm, transformer
    from repro_torch.runtime import lm_serve

    cfg = get_config(LM_ARCH)
    s_max = LM_PROMPT + LM_TOKENS
    t0 = time.perf_counter()
    params = transformer.init_params(SEED, cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=gen, device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[lm] {LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} query / {cfg.n_kv_heads} kv heads of {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {n_params:,} parameters "
        f"in {cfg.dtype} ({time.perf_counter() - t0:.1f} s to draw); prompt "
        f"B={LM_BATCH} x {LM_PROMPT} tokens, {LM_TOKENS} new, s_max {s_max}")

    batch = {"tokens": prompt}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = lm_serve.generate(params, cfg, batch, n_tokens=LM_TOKENS,
                            s_max=s_max)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(counts["flash_attention"] == cfg.n_layers,
          f"flash_attention launched {counts['flash_attention']} times in "
          f"one generate, not once per layer of the prefill ({cfg.n_layers})")
    check(tuple(out.shape) == (LM_BATCH, LM_TOKENS)
          and out.dtype == torch.int32, f"generate gave {tuple(out.shape)} "
          f"{out.dtype}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "generated tokens outside the vocabulary")
    log(f"[lm] generate: {t_gen * 1e3:.1f} ms for {LM_BATCH} x {LM_TOKENS} "
        f"tokens after the prompt; launches {counts}; peak memory "
        f"{peak / 2**30:.2f} GiB")

    # decode at position 4096 against a fresh prefill of the 4097 tokens
    logits_p, caches = lm.prefill(params, cfg, batch, s_max=s_max)
    check(torch.equal(logits_p[:, -1, :cfg.vocab_size].argmax(-1).int(),
                      out[:, 0]), "prefill's argmax is not generate's first "
          "token")
    logits_d, _ = lm.decode_step(params, cfg, out[:, :1], caches, LM_PROMPT)
    check(torch.equal(logits_d[:, -1, :cfg.vocab_size].argmax(-1).int(),
                      out[:, 1]), "decode's argmax is not generate's second "
          "token")
    longer = {"tokens": torch.cat([prompt, out[:, :1]], dim=1)}
    logits_f, _ = lm.prefill(params, cfg, longer)
    ld = logits_d[:, -1, :cfg.vocab_size].float()
    lf = logits_f[:, -1, :cfg.vocab_size].float()
    check(bool(torch.isfinite(ld).all() and torch.isfinite(lf).all()),
          "non-finite logits")
    row_diff = (ld - lf).abs().amax(-1)
    diff = float(row_diff.max())
    scale = float(lf.abs().max())
    top2 = lf.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    same = ld.argmax(-1) == lf.argmax(-1)
    check(diff <= LM_LOGIT_ATOL, f"decode logits differ from a fresh "
          f"prefill's by {diff} (atol {LM_LOGIT_ATOL}, logits up to {scale})")
    check(bool(same.all()), f"decode and prefill pick other tokens: same "
          f"argmax {same.tolist()}, top-2 gaps {gap.tolist()}, row "
          f"differences {row_diff.tolist()}")
    log(f"[lm] decode at position {LM_PROMPT} vs a fresh prefill of "
        f"{LM_PROMPT + 1} tokens (ragged: the kernel masks the edge): "
        f"largest logit difference {diff:.4f} (atol {LM_LOGIT_ATOL}; logits "
        f"up to {scale:.3f}; by row {[round(x, 4) for x in row_diff.tolist()]}"
        f"); same argmax in rows {same.tolist()}; top-2 gaps "
        f"{[round(x, 4) for x in gap.tolist()]}")
    del caches, logits_p, logits_d, logits_f, longer

    again = lm_serve.generate(params, cfg, batch, n_tokens=LM_TOKENS,
                              s_max=s_max)
    check(torch.equal(out, again), "a second generate gave other tokens")
    log("[lm] a second generate gave identical tokens")

    t_prefill = host_ms(lambda: lm.prefill(params, cfg, batch, s_max=s_max))
    _, caches = lm.prefill(params, cfg, batch, s_max=s_max)
    tok = out[:, :1]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(LM_TOKENS - 1):
        lm.decode_step(params, cfg, tok, caches, LM_PROMPT + i)
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t) * 1e3 / (LM_TOKENS - 1)
    decode_dev, decode_how = device_or_stream_ms(
        lambda: lm.decode_step(params, cfg, tok, caches, LM_PROMPT), 3)
    # one layer's decode attention over the whole s_max cache, and the
    # float32 cast of its k and v caches inside it
    k_l, v_l = caches["kv"][0][0], caches["kv"][1][0]
    qg = torch.zeros((LM_BATCH, 1, cfg.n_kv_heads,
                      cfg.n_heads // cfg.n_kv_heads, cfg.head_dim),
                     dtype=k_l.dtype, device="cuda")
    attn_dev, attn_how = device_or_stream_ms(
        lambda: attention.decode_attention(qg, k_l, v_l, LM_PROMPT + 1), 5)
    cast_dev, cast_how = device_or_stream_ms(
        lambda: (k_l.float(), v_l.float()), 5)
    prompt_rate = LM_BATCH * LM_PROMPT / t_prefill * 1e3
    log(f"[lm] prefill {t_prefill:.1f} ms ({prompt_rate:.0f} prompt "
        f"tokens/s); decode {t_dec:.2f} ms per step of "
        f"{LM_BATCH} tokens ({LM_BATCH / t_dec * 1e3:.1f} tokens/s), "
        f"{decode_dev:.2f} ms of it {decode_how}; per layer, decode "
        f"attention over the {s_max}-slot cache {attn_dev:.4f} ms "
        f"{attn_how}, of which the float32 cast of its k and v "
        f"{cast_dev:.4f} ms {cast_how} (x "
        f"{cfg.n_layers} layers: {attn_dev * cfg.n_layers:.2f} / "
        f"{cast_dev * cfg.n_layers:.2f} ms); generate "
        f"{LM_BATCH * LM_TOKENS / t_gen:.1f} new tokens/s end to end "
        f"(host clock)")
    del caches

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    lm.prefill(params, cfg, batch, s_max=s_max)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        lm.prefill(params, cfg, batch, s_max=s_max)
        torch.cuda.synchronize()
    split = {"attention kernel": 0.0, "matmuls": 0.0, "rest": 0.0}
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        if "flash_attn" in e.name:
            split["attention kernel"] += us
        elif any(w in e.name.lower() for w in MATMUL_NAMES):
            split["matmuls"] += us
        else:
            split["rest"] += us
    busy = sum(split.values()) / 1e3
    if busy == 0:
        log("[lm] the profiler saw no device activity in one prefill: no "
            "split")
        return dict(counts=counts)
    log(f"[lm] one prefill's device time {busy:.1f} ms (host clock "
        f"{t_prefill:.1f} ms, idle share {1 - busy / t_prefill:.3f}): "
        + ", ".join(f"{k} {v / 1e3:.1f} ms ({v / 1e3 / busy:.1%})"
                    for k, v in split.items()))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log("[lm] largest device activities of one prefill: " + "; ".join(
        f"{n[:70]} {us / 1e3:.2f} ms" for n, us in top))
    return dict(counts=counts)


# substrings of the cuBLAS / CUTLASS GEMM kernels' names in a trace
MATMUL_NAMES = ("gemm", "nvjet", "xmma", "cutlass", "matmul")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


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
    results["flash_attention"] = phase_flash(rng)
    launches = dict.fromkeys(results, 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        tree_path = phase_main_path(problem, out_dir)
    mlp_paths = {}
    for name, pop in MLP_RUNS:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mlp_") as out_dir:
            mlp_paths[name] = phase_mlp_path(mlp_problems[name], name, pop,
                                             out_dir)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_forest_") as out_dir:
        forest_path = phase_forest(rng, out_dir)
    lm_path = phase_lm()
    for path in (tree_path, *mlp_paths.values(), forest_path, lm_path):
        for name, count in path["counts"].items():
            launches[name] += count
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main paths never launched: {launches}")
    for name, count in launches.items():
        results[name]["launches"] = count
        results[name]["what"] = TPU_KERNELS[name][2]

    from repro_torch.search import make_kernel_fitness
    phase_breakdown(f"tree {DATASET}", make_kernel_fitness(problem),
                    tree_path["state"], problem.n_genes, problem.device,
                    "fitness_mma_kernel")
    mp = mlp_problems[MLP_RUNS[0][0]]
    phase_breakdown(f"mlp {MLP_RUNS[0][0]}", pm.make_kernel_fitness(mp),
                    mlp_paths[MLP_RUNS[0][0]]["state"], mp.n_genes,
                    mp.device, "qmatmul_u8")

    for what, prob, fit in (
            (f"tree {DATASET}", problem, make_kernel_fitness(problem)),
            (f"mlp {MLP_RUNS[0][0]}", mp, pm.make_kernel_fitness(mp))):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_chunk_") as d:
            phase_chunk(what, prob, fit, d)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as d:
        phase_resume(problem, d)

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
