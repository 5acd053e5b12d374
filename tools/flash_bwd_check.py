#!/usr/bin/env python3
"""Check and time the gradient of the port's `flash_attention` on one card.

    python3 tools/flash_bwd_check.py           # from the repository root
    python3 tools/flash_bwd_check.py --quick   # checks only, no timing

Builds `src/repro_torch/csrc/flash_attn.cu` and `flash_attn_bwd.cu`,
prints nvcc's registers and spills for each kernel and ptxas's warnings
(wgmma serialised for want of registers among them), then runs
`chip_smoke.py`'s backward phase alone: `check_flash_backward` at every
case of `flash_bwd_cases` (the kept log-sum-exp, dq, dk and dv against the
plain backward by `grad_error`, two calls bit-equal, autograd through both
wrappers giving the kernel's bits, planted faults read where the scores
reach the softcap) and, without ``--quick``, the model shapes timed beside
the plain backward, the bound and SDPA's backward. Exits 1 on the first
failed check.
"""
from __future__ import annotations

import pathlib
import sys

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
    secs = _build.build(("flash_attn", "flash_attn_bwd"))
    cs.log(f"[build] flash_attn, flash_attn_bwd: {secs:.1f} s")
    for name in ("flash_attn", "flash_attn_bwd"):
        cs.log(f"[build] {name} by kernel: "
               + "; ".join(cs.ptxas_kernels(name)))
        for ln in _build.build_log(name).splitlines():
            if "warning" in ln.lower() or "Performance Loss" in ln:
                cs.log(f"[build] {name}: {ln.strip()}")
    cs.phase_flash_backward(timing="--quick" not in sys.argv)
    cs.log(cs.smi_line())
    cs.log("flash_bwd_check: ok")


if __name__ == "__main__":
    main()
