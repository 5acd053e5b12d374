#!/usr/bin/env python3
"""Check the MoE serving path on one CUDA card: `chip_smoke.py`'s `[flash]`
and `[moe]` phases alone.

    python3 tools/moe_check.py           # from the repository root

Builds `flash_attn.cu`, holds `flash_attention` to its plain version at
every `[flash]` shape (grok-1-314b's softcapped GQA and kimi-k2-1t-a32b's
included) and times the four model shapes beside their bounds and, without
a softcap, `scaled_dot_product_attention`; then serves grok-1-314b (8 of
64 layers) and kimi-k2-1t-a32b (1 of 61) at their published width through
`generate` (B=4 x 4096 prompt, 32 greedy tokens), held to a fresh prefill
on the rows that routed alike, to a second `generate` and to no host sync
in `moe_block`, with prefill and decode times, peak memory, one prefill's
device time split and one MoE layer's pieces. Prints the card's name and
power limit and the attention's kernel rows as one JSON line. Exits 1 on
the first failed check.
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
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    cs.log(f"[build] flash_attn {_build.build(('flash_attn',)):.1f} s")
    rows = cs.phase_flash(np.random.default_rng(cs.SEED))
    for arch, n_layers in cs.MOE_ARCHS:
        counts = cs.phase_moe(arch, n_layers)["counts"]
        if arch == cs.MOE_ARCHS[0][0]:
            rows[cs.FLASH_SOFTCAP]["launches"] = counts["flash_attention"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    cs.log(f"[done] {time.perf_counter() - t0:.1f} s in all")
    cs.log(smi.stdout.strip().splitlines()[0])
    cs.log(json.dumps({"kernels": list(rows.values())}))


if __name__ == "__main__":
    main()
