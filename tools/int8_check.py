#!/usr/bin/env python3
"""Check and time the port's int8 tensor-core kernels on one CUDA card.

    python3 tools/int8_check.py            # from the repository root

Builds `src/repro_torch/csrc/fitness.cu` and `qmatmul.cu` and prints nvcc's
registers and spills for each kernel; measures the issue rate of the
`mma.sync.m16n8k32` forms they use (`tools/mma_rate.cu`: independent
chains on register operands, no memory traffic) at 1 to 8 chains per warp;
then holds each kernel to its plain version at the main paths' shapes and
times it beside its bound (`chip_smoke.timed` and `chip_smoke.bound`):
`qmatmul` on uint8 codes at the printed-MLP fitness shape (3090 x 561) @
(561 x 8192) and at N=16 for M = 1, 37, 1024 and 3090, beside `torch.mm`;
`fitness_correct_counts` at the `har` tree's shape (P=512, B=3090, N=588,
L=589, C=6) on random operands whose leaf targets are the number of +1
path entries, as a tree's are. It is the quick check of these kernels
between runs of `chip_smoke.py`. Exits 1 on the first failed check.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

PROBE_ITERS = 4096


def mma_rates() -> None:
    """TOP/s of mma.sync m16n8k32 by chains per warp (8 warps a block,
    4 blocks per SM)."""
    from repro_torch.kernels import _build

    out = _build.BUILD_DIR / "libmma_rate.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(out),
                    str(ROOT / "tools" / "mma_rate.cu")],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).repro_mma_rate
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads = 4 * sms, 256
    sink = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for unsigned_a, kind in ((1, "u8 x s8"), (0, "s8 x s8")):
        rates = []
        for chains in (1, 2, 4, 8):
            def run():
                cs.check(fn(blocks, threads, PROBE_ITERS, chains, unsigned_a,
                            sink.data_ptr(), stream) == 0, "probe launch")
            ms = cs.stream_ms(run, 5)
            ops = blocks * threads // 32 * PROBE_ITERS * chains * 8192
            rates.append(f"{chains} chains {ops / ms / 1e9:.0f}")
        cs.log(f"[mma] mma.sync m16n8k32 {kind} -> s32, {threads // 32} "
               f"warps a block, {blocks} blocks, TOP/s by independent "
               f"chains per warp: {'; '.join(rates)}")


def check_qmatmul(rng) -> None:
    from repro_torch.kernels import qmatmul as qmm

    b, f, h, pop = 3090, 561, 16, 512
    x = qmm.code_buffer(torch.as_tensor(
        rng.integers(0, 256, (b, f)).astype(np.uint8), device="cuda"))
    w = torch.as_tensor(rng.integers(-8, 8, (f, pop * h)).astype(np.int8),
                        device="cuda")
    ones = torch.ones(pop * h, device="cuda")
    cases = [("fitness", x, w, ones)] + [
        (f"N=16 M={m}", x[:m], w[:, :h].contiguous(), ones[:h].contiguous())
        for m in (1, 37, 1024, b)]
    for name, xc, wc, sc in cases:
        got = qmm.qmatmul(xc, wc, sc)
        torch.cuda.synchronize()
        cs.check(torch.equal(got, qmm.qmatmul_plain(xc, wc, sc)),
                 f"qmatmul {name} differs from its plain version")
        ms, plain_ms, text = cs.timed(lambda: qmm.qmatmul(xc, wc, sc),
                                      lambda: qmm.qmatmul_plain(xc, wc, sc),
                                      "qmatmul", reps=20, plain_reps=5)
        m, k = xc.shape
        n = wc.shape[1]
        xf, wf = xc.to(torch.float32), wc.to(torch.float32)
        lib_ms, _ = cs.device_or_stream_ms(lambda: torch.mm(xf, wf), 20)
        bms, by = cs.bound(m * k + k * n + n * 4 + m * n * 4, 2 * m * k * n,
                           cs.INT8_OPS_PER_S)
        cs.log(f"[qmatmul] {name} ({m}x{k} @ {k}x{n}): equal; {text}; "
               f"torch.mm {lib_ms:.4f} ms; bound {bms:.5f} ms ({by}); "
               f"{ms / bms:.2f}x its bound, {ms / lib_ms:.2f}x torch.mm")


def check_fitness(rng) -> None:
    from repro_torch.core import quant
    from repro_torch.kernels import fitness, ops

    p, b, n, l, c = 512, 3090, 588, 589, 6
    path = rng.choice(np.array([-1, 0, 0, 0, 1], np.int8), (l, n))
    fit = ops.prepare_fitness_operands(
        torch.as_tensor(rng.integers(0, 256, (b, n)), device="cuda"),
        rng.integers(0, c, b), path, (path == 1).sum(1), np.zeros(l),
        rng.integers(0, c, l), c)
    bits = rng.integers(0, 9, (p, n))
    shift = torch.as_tensor(8 - bits, dtype=torch.int32, device="cuda")
    thr = torch.as_tensor(rng.integers(0, 256, (p, n)) % (1 << bits),
                          dtype=torch.int32, device="cuda")
    cap = torch.as_tensor(np.where(rng.random(p) < 0.5, 1, quant.NO_VOTE_CAP),
                          dtype=torch.int32, device="cuda")
    got = fitness.fitness_correct_counts(fit, shift, thr, cap)
    torch.cuda.synchronize()
    cs.check(torch.equal(got, fitness.fitness_correct_counts_plain(
        fit, shift, thr, cap)), "fitness_correct_counts differs from its "
        "plain version")
    ms, plain_ms, text = cs.timed(
        lambda: fitness.fitness_correct_counts(fit, shift, thr, cap),
        lambda: fitness.fitness_correct_counts_plain(fit, shift, thr, cap),
        "fitness", reps=10, plain_reps=2)
    n_ops = cs.tree_ops(p, b, n, l, c)
    bms, by = cs.bound(0, n_ops, cs.INT8_OPS_PER_S)
    cs.log(f"[fitness] P={p} B={b} N={n} L={l} C={c}: equal; {text}; "
           f"{n_ops / ms / 1e9:.1f} TOP/s, {ms / bms:.2f}x its bound "
           f"({bms:.4f} ms, {by}); {fitness.BLOCK_ROWS}"
           f" rows a block")


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    from repro_torch.kernels import _build

    cs.log(f"[build] {_build.build(('fitness', 'qmatmul')):.1f} s")
    for name in ("fitness", "qmatmul"):
        cs.log(f"[build] {name}: " + "; ".join(cs.ptxas_kernels(name)))
    mma_rates()
    rng = np.random.default_rng(0)
    check_qmatmul(rng)
    check_fitness(rng)
    cs.log("[int8_check] all checks passed")


if __name__ == "__main__":
    main()
