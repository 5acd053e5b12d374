#!/usr/bin/env python3
"""Check and time the tree-vote kernel and the non-dominated sort on one
CUDA card.

    python3 tools/tree_sort_check.py        # from the repository root

Builds `src/repro_torch/csrc/tree_infer.cu` and `domination.cu` and prints
nvcc's registers and spills for each kernel. Then holds each kernel to its
plain version and times it (`chip_smoke.timed`) beside its bound
(`chip_smoke.bound`):

- `tree_infer_scores` at the `har` tree's widths (N=588 comparators, L=589
  leaves, C=6, F=561) on random operands of a tree's shape (eight
  comparators a path, each target the path's number of +1 entries) at
  P=1 for B = 1, 37, 1024 and 3090, at P=8 for B=3090, and at N=2048;
  beside it the fitness kernel's int8 path product at P=1, B=3090;
- the sort (`domination_bits` and the front peel) at pools 256, 1024, 1500
  and 4096, on a 1024-point chain (1024 fronts) and, ranks only, at pool
  30000 (the peel's state in global memory), each under
  `torch.cuda.set_sync_debug_mode("error")`, against the host loop, with
  the device time of each of its two kernels.

It is the quick check of these kernels between runs of `chip_smoke.py`.
Exits 1 on the first failed check.
"""
from __future__ import annotations

import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def tree_case(rng, n, n_leaves, c, f, depth=8):
    """Static operands of a random tree-shaped leaf set, on the card."""
    from repro_torch.kernels import ops

    path = np.zeros((n_leaves, n), np.int8)
    for i in range(n_leaves):
        path[i, rng.choice(n, depth, replace=False)] = rng.choice([-1, 1],
                                                                  depth)
    return ops.prepare_operands(
        rng.integers(0, f, n), path, (path != 0).sum(1), (path == -1).sum(1),
        rng.integers(0, c, n_leaves), c, f, device="cuda")


def chromosomes(rng, p, n):
    bits = rng.integers(1, 9, (p, n))
    shift = torch.as_tensor(8 - bits, dtype=torch.int32, device="cuda")
    thr = torch.as_tensor(rng.integers(0, 256, (p, n)) % (1 << bits),
                          dtype=torch.int32, device="cuda")
    return shift, thr


def check_tree(rng) -> None:
    from repro_torch.core import quant
    from repro_torch.kernels import fitness, ops, tree_infer

    f, c, rows_all = 561, 6, 3090
    x8 = torch.as_tensor(rng.integers(0, 256, (rows_all, f)),
                         dtype=torch.int32, device="cuda")
    main = None
    for n, l, cases in ((588, 589, ((1, 1), (1, 37), (1, 1024), (1, 3090),
                                    (8, 3090))),
                        (2048, 2049, ((1, 3090),))):
        operands = tree_case(rng, n, l, c, f)
        for p, rows in cases:
            shift, thr = chromosomes(rng, p, n)
            x = x8[:rows].contiguous()
            got = tree_infer.tree_infer_scores(x, operands, shift, thr)
            torch.cuda.synchronize()
            want = tree_infer.tree_infer_scores_plain(x, operands, shift, thr)
            cs.check(torch.equal(got, want), f"tree_infer_scores P={p} "
                     f"B={rows} N={n} differs from its plain version by "
                     f"{int((got - want).abs().max())}")
            ms, plain_ms, text = cs.timed(
                lambda: tree_infer.tree_infer_scores(x, operands, shift, thr),
                lambda: tree_infer.tree_infer_scores_plain(x, operands, shift,
                                                           thr),
                "tree_infer_kernel", reps=50, plain_reps=5)
            n_ops = cs.tree_ops(p, rows, n, l, c)
            n_bytes = (rows * f * 4 + n * 4 + 2 * p * n * 4
                       + 2 * l * operands.pos.shape[1] * 4 + 2 * l * 4
                       + p * rows * c * 4)
            bms, by = cs.bound(n_bytes, n_ops, cs.INT8_OPS_PER_S)
            cs.log(f"[tree] P={p} B={rows} N={n} L={l}: equal "
                   f"({int(want.sum())} votes); {text}; bound {bms:.5f} ms "
                   f"({by}); {ms / bms:.1f}x its bound")
            if (p, rows, n) == (1, 3090, 588):
                main = (operands, shift, thr, ms)
    # the int8 mma.sync path product of the fitness kernel at P = 1
    operands, shift, thr, ms = main
    x_sel = x8[:, operands.feature.long()]
    fit_ops = ops.prepare_fitness_operands(
        x_sel, torch.zeros(rows_all, dtype=torch.int32), operands.path,
        (operands.path != 0).sum(1), (operands.path == -1).sum(1),
        operands.leaf_class, c, device="cuda")
    cap = torch.full((1,), quant.NO_VOTE_CAP, dtype=torch.int32,
                     device="cuda")
    mma_ms = cs.device_ms(lambda: fitness.fitness_correct_counts(
        fit_ops, shift, thr, cap), 50, "fitness_mma_kernel")
    cs.log(f"[tree] the int8 path product at P=1 B={rows_all} "
           f"(fitness_mma_kernel, correct counts only): {mma_ms:.4f} ms "
           f"device time, against tree_infer_scores' {ms:.4f} ms")


def check_sort(rng) -> None:
    from repro_torch.kernels import domination

    cases = [(f"pool {p}", (rng.integers(0, 64, (p, 2)) / 63)
              .astype(np.float32)) for p in (256, 1024, 1500, 4096)]
    v = rng.permutation(1024).astype(np.float32)
    cases.append(("chain 1024", np.stack([v, v / 3], 1)))
    # a pool whose counts and ranks no longer fit shared memory: the peel
    # keeps them in global memory (ranks only; the plain relation would
    # take 15 GB)
    big = torch.as_tensor((rng.integers(0, 64, (30000, 2)) / 63)
                          .astype(np.float32), device="cuda")
    got = cs.sync_free(lambda: domination.non_dominated_rank(big),
                       "pool 30000")
    want = domination.non_dominated_rank_plain(big)
    cs.check(torch.equal(got, want), "the sort at pool 30000 differs from "
             "the host loop")
    peel_ms = cs.device_ms(lambda: domination.non_dominated_rank(big), 3,
                           "peel_kernel")
    cs.log(f"[sort] pool 30000, {int(got.max()) + 1} fronts: ranks equal the "
           f"host loop, no host sync; peel {peel_ms:.4f} ms")
    del big, got, want
    for name, objs_np in cases:
        objs = torch.as_tensor(objs_np, device="cuda")
        p = objs.shape[0]
        rel, counts = domination.domination_bits(objs)
        torch.cuda.synchronize()
        want_rel, want_counts = domination.domination_bits_plain(objs)
        cs.check(torch.equal(rel, want_rel) and torch.equal(counts,
                                                            want_counts),
                 f"domination_bits {name} differs from its plain version")
        got = cs.sync_free(lambda: domination.non_dominated_rank(objs), name)
        torch.cuda.synchronize()
        want = domination.non_dominated_rank_plain(objs)
        cs.check(torch.equal(got, want), f"the sort {name} differs from the "
                 f"host loop by {int((got - want).abs().max())} ranks")
        ms, plain_ms, text = cs.timed(
            lambda: domination.non_dominated_rank(objs),
            lambda: domination.non_dominated_rank_plain(objs),
            None, reps=20, plain_reps=3)
        bits_ms = cs.device_ms(lambda: domination.domination_bits(objs), 20,
                               "domination_bits_kernel")
        peel_ms = cs.device_ms(lambda: domination.non_dominated_rank(objs),
                               20, "peel_kernel")
        fronts = int(got.max()) + 1
        n_ops = 3 * 2 * p * p + cs.peel_ops(got)
        bms, by = cs.bound(p * 3 * 4, n_ops, cs.FP32_OPS_PER_S)
        cs.log(f"[sort] {name}, {fronts} fronts: ranks equal the host loop, "
               f"no host sync; {text}; relation {bits_ms:.4f} ms + peel "
               f"{peel_ms:.4f} ms ({peel_ms / fronts * 1e3:.2f} us a front); "
               f"bound {bms:.5f} ms ({by})")


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("needs a CUDA device")
    from repro_torch.kernels import _build

    seconds = _build.build(("tree_infer", "domination", "fitness"))
    cs.log(f"[build] {seconds:.1f} s")
    for name in ("tree_infer", "domination"):
        cs.log(f"[build] {name}: " + "; ".join(cs.ptxas_kernels(name)))
    rng = np.random.default_rng(0)
    check_tree(rng)
    check_sort(rng)
    cs.log(cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
