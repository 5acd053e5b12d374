#!/usr/bin/env python3
"""Run `chip_smoke.py`'s `[train]` phase alone on one CUDA card.

    python3 tools/train_check.py           # from the repository root

Builds the attention kernels (`flash_attn.cu`, `flash_attn_bwd.cu`), then
trains llama3.2-3b at full width (B=2 x 4096, AdamW, 4 steps and 3 on a
fixed batch) and grok-1-314b cut to one layer (B=4 x 4096, grad_accum 4
in bf16, Adafactor, 2 steps) through `launch.train`'s loop, with the
reduced float32 card-vs-CPU step and the resume check between them
(`phase_train`). Exits 1 on the first failed check; the quick check of the
training path between runs of `chip_smoke.py` (`tools/flash_bwd_check.py`
checks the backward kernels alone).
"""
from __future__ import annotations

import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    secs = _build.build(("flash_attn", "flash_attn_bwd"))
    cs.log(f"[build] flash_attn, flash_attn_bwd: {secs:.1f} s")
    cs.phase_train()
    cs.log(cs.smi_line())
    cs.log(f"train_check: ok ({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
