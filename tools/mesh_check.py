#!/usr/bin/env python3
"""Check the multi-device search on the CUDA cards: `chip_smoke.py`'s
`[mesh]` phase alone.

    python3 tools/mesh_check.py [--ranks N]   # from the repository root

Builds the kernels, trains the `har` tree and runs the single-card runs
the phase is held to: `chip_smoke.phase_main_path` (pop 512, 8
generations, verify_rtl, serving) and the mixed sweep campaign batched.
Then `chip_smoke.phase_mesh` spawns N ranks (default 2; rank r on card
r % cards, over gloo when ranks share a card and NCCL when each has its
own) and checks (a) `--mesh N`, (b) its save resumed with no mesh, (c)
islands on an N-ring and (d) the mixed sweep on an Nx1 mesh against them,
times a sharded generation against a captured single-card chunk, and
times `domination_block` and `fitness_errors` at a rank's shapes beside
their bounds. Prints the card's name and power limit and the phase's kernel
rows as one JSON line. Exits 1 on the first failed check.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(prog="python3 tools/mesh_check.py")
    ap.add_argument("--ranks", type=int, default=cs.MESH_RANKS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this check needs a "
                "CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import search
    from repro_torch.core.train import train_tree
    from repro_torch.core.tree import to_parallel
    from repro_torch.datasets import load_dataset
    from repro_torch.search import sweep

    t_start = time.perf_counter()
    cs.log(f"[build] {cs.phase_build():.1f} s")
    ds = load_dataset(cs.DATASET)
    problem = search.build_problem(
        to_parallel(train_tree(ds.x_train, ds.y_train, ds.n_classes)),
        ds.x_test, ds.y_test, device="cuda")
    with tempfile.TemporaryDirectory(prefix="mesh_check_") as d:
        tree_path = cs.phase_main_path(problem, d)
    m = cs.SWEEP_MIXED
    mixed = sweep.build_problems(m["datasets"], n_trees=m["n_trees"],
                                 mlp_datasets=m["mlp_datasets"],
                                 device="cuda")
    batched = sweep.run_sweep(mixed, pop_size=m["pop"],
                              n_generations=m["gens"], seed=cs.SEED,
                              max_buckets=m["max_buckets"])
    with tempfile.TemporaryDirectory(prefix="mesh_check_") as d:
        mesh_path = cs.phase_mesh(problem, tree_path,
                                  dict(mixed=mixed, mixed_result=batched), d,
                                  np.random.default_rng(cs.SEED),
                                  n_ranks=args.ranks)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    cs.log(f"[done] {time.perf_counter() - t_start:.1f} s in all, "
           f"{torch.cuda.device_count()} card(s)")
    for line in smi.stdout.strip().splitlines():
        cs.log(line)
    cs.log(json.dumps({"kernels": list(mesh_path["rows"].values())}))


if __name__ == "__main__":
    main()
