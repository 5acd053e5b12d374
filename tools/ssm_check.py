#!/usr/bin/env python3
"""Check the SSM and hybrid serving paths on one CUDA card:
`chip_smoke.py`'s `[flash]` and `[ssm]` phases alone.

    python3 tools/ssm_check.py           # from the repository root

Builds `flash_attn.cu`, holds `flash_attention` to its plain version at
every `[flash]` shape (zamba2-7b's head dim 112 included) and times both
model shapes beside their bounds and `scaled_dot_product_attention`; then
serves mamba2-1.3b and zamba2-7b at full width through `generate` (B=4 x
4096 prompt, 32 greedy tokens), held to a fresh prefill and to a second
`generate`, with prefill and decode times, peak memory and one prefill's
device time split. Prints the card's name and power limit and the
attention's kernel rows as one JSON line. Exits 1 on the first failed
check.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    cs.log(f"[build] flash_attn {_build.build(('flash_attn',)):.1f} s")
    rows = cs.phase_flash(np.random.default_rng(cs.SEED))
    for arch in cs.SSM_ARCHS:
        counts = cs.phase_ssm(arch)["counts"]
        if arch == cs.SSM_ARCHS[1]:
            rows[cs.FLASH_112]["launches"] = counts["flash_attention"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    cs.log(f"[done] {time.perf_counter() - t0:.1f} s in all")
    cs.log(smi.stdout.strip().splitlines()[0])
    cs.log(json.dumps({"kernels": list(rows.values())}))


if __name__ == "__main__":
    main()
