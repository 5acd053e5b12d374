#!/usr/bin/env python3
"""Check and time the stuck-at simulator's fault-lane kernel on one CUDA
card.

    python3 tools/fault_check.py            # from the repository root

Builds `src/repro_torch/csrc/fault_sim.cu` and prints nvcc's registers and
spills. Then, on the benchmark's `tree-har` exact circuit (its inputs made
by `perfbench`, as the `tree-har.faults` cell makes them: 2,706 gates,
5,408 single lanes, 3,090 rows), holds the kernel to its plain version and
times it beside its bound (`chip_smoke.fault_kernel_row`), runs the
campaign at the default chunk (one launch) and at 64 lanes a launch
(`chip_smoke.fault_campaign`), and times whole `point_robustness`
campaigns on the host clock. On random printed-MLP circuits of the
pendigits shape (F=16, H=16, C=10) and of the har shape (F=561, H=16,
C=6), both past shared memory (the global scratch), it holds a spread of
lanes to the plain version and times the kernel.

It is the quick check of this kernel between runs of `chip_smoke.py`.
Exits 1 on the first failed check.
"""
from __future__ import annotations

import pathlib
import statistics
import sys
import time
import types

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

CAMPAIGNS = 5            # whole campaigns timed on the host clock
MLP_LANES = 2048         # single lanes of the MLP circuits, spread


def bench_circuit():
    """(circuit, x8, y) of the `tree-har` cell: its exact design over the
    whole test split."""
    from perfbench import inputs
    from perfbench.families import tree
    from perfbench.reference import data

    made = inputs.load(ROOT / "perfbench/configs/tree-har.json", tree, ROOT)
    circuit = tree.exact_circuit(types.SimpleNamespace(inputs=made))
    return (circuit, data.quantize_u8(made["x_test"]),
            made["y_test"].astype(np.int64))


def mlp_circuit(rng, f: int, h: int, c: int):
    from repro_torch.core import netlist
    from repro_torch.families import printed_mlp as pm

    w1 = rng.integers(-7, 8, (f, h))
    w2 = rng.integers(-7, 8, (h, c))
    return netlist.build_mlp_circuit(w1, w2, pm.pick_shift(f, h), c)


def check_mlp(rng, what: str, circuit, b: int, plain_lanes: int) -> None:
    """A spread of ``MLP_LANES`` single lanes: kernel == plain
    (``plain_lanes`` a call), then the kernel's device ms."""
    from repro_torch.core import faults
    from repro_torch.kernels import fault_sim

    gates, values = faults.single_fault_lanes(circuit)
    pick = np.unique(np.linspace(0, len(gates) - 1, MLP_LANES).astype(int))
    x8 = rng.integers(0, 256, (b, int(circuit.a[circuit.op == 2].max()) + 1))
    sim = faults.FaultSimulator(circuit, device="cuda")
    mask, val = faults.site_masks(circuit.n_gates, gates[pick], values[pick])
    mask_t = torch.as_tensor(mask, device="cuda")
    val_t = torch.as_tensor(val, device="cuda")
    base = fault_sim.pack_words(sim._base_bits(
        torch.as_tensor(x8, device="cuda").to(torch.int32)))
    got = fault_sim.fault_lanes(base, sim._tables, mask_t, val_t, b)
    want = torch.cat([fault_sim.fault_lanes_plain(
        base, sim._tables, mask_t[lo:lo + plain_lanes],
        val_t[lo:lo + plain_lanes], b)
        for lo in range(0, len(pick), plain_lanes)])
    cs.check(torch.equal(got, want), f"{what}: fault_lanes differs from its "
             f"plain version on {int((got != want).sum())} classes")
    ms = cs.device_ms(lambda: fault_sim.fault_lanes(
        base, sim._tables, mask_t, val_t, b), 3, "fault_lanes_kernel")
    log_t, in_smem = fault_sim.placement(circuit.n_gates)
    cs.log(f"[mlp] {what}: G={circuit.n_gates}, "
           f"{sim._tables.level_off.numel() - 1} levels, {len(pick)} lanes x "
           f"{b} rows, {1 << log_t}-word tiles in "
           f"{'shared memory' if in_smem else 'global scratch'}: equal to "
           f"the plain version; {ms:.3f} ms, {ms / len(pick) * 1e3:.2f} us a "
           f"lane")


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("needs a CUDA device")
    from repro_torch.core import faults
    from repro_torch.kernels import _build
    from repro_torch.search import robustness

    seconds = _build.build(("fault_sim",))
    cs.log(f"[build] fault_sim {seconds:.1f} s: "
           + "; ".join(cs.ptxas_kernels("fault_sim")))
    t0 = time.perf_counter()
    circuit, x8, y = bench_circuit()
    cs.log(f"[bench] tree-har exact circuit: G={circuit.n_gates}, "
           f"{x8.shape[0]} rows ({time.perf_counter() - t0:.1f} s to make)")
    gates, values = faults.single_fault_lanes(circuit)
    row = cs.fault_kernel_row("tree-har exact", circuit, x8, gates, values)
    cs.log(f"[bench] row: {row}")
    sim = faults.FaultSimulator(circuit, device="cuda")
    auto, _ = cs.fault_campaign("tree-har exact", sim, x8, gates, values,
                                None)
    at64, _ = cs.fault_campaign("tree-har exact", sim, x8, gates, values, 64)
    cs.check(np.array_equal(auto, at64), "the campaign at 64 lanes a launch "
             "differs from the default chunk")
    walls = []
    for i in range(CAMPAIGNS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        robustness.point_robustness(circuit, x8, y, defect_rate=0.02,
                                    n_trials=32, seed=i, device="cuda")
        walls.append(time.perf_counter() - t0)
    lanes = 1 + len(gates) + 32
    med = statistics.median(walls[1:])
    cs.log(f"[bench] point_robustness, {lanes} lanes: "
           f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms (the first "
           f"builds); median of the last {CAMPAIGNS} {med * 1e3:.1f} ms, "
           f"{lanes / med:.0f} lanes/s")

    rng = np.random.default_rng(0)
    check_mlp(rng, "pendigits-shaped MLP", mlp_circuit(rng, 16, 16, 10),
              3498, 256)
    check_mlp(rng, "har-shaped MLP", mlp_circuit(rng, 561, 16, 6), 3090, 16)
    cs.log(cs.smi_line())


if __name__ == "__main__":
    main()
