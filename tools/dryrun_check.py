#!/usr/bin/env python3
"""Run `chip_smoke.py`'s `[dryrun]` and `[examples]` phases on one CUDA card,
with the phases they are held against.

    python3 tools/dryrun_check.py           # from the repository root

Starts the dry run's host subprocess (`chip_smoke.dryrun_side`: the meta
step, the fake (2, 2) group, the production cells), runs `[train]` (whose
llama3.2-3b step is analysed on the card) and `[lm-mesh]` (a) for
llama3.2-3b alone, then holds the dry run to both (`phase_dryrun`) and
runs the five torch examples on the card (`phase_examples`). Exits 1 on
the first failed check.
"""
from __future__ import annotations

import pathlib
import sys
import tempfile
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
    with tempfile.TemporaryDirectory(prefix="dryrun_check_") as d:
        out = str(pathlib.Path(d) / "dryrun.json")
        proc = cs.start_dryrun(out)
        secs = _build.build(("flash_attn", "flash_attn_bwd"))
        cs.log(f"[build] flash_attn, flash_attn_bwd: {secs:.1f} s")
        train = cs.phase_train()
        torch.cuda.empty_cache()
        lm = cs.phase_lm_mesh(str(pathlib.Path(d) / "lm_mesh"),
                              plans=(cs.LM_MESH_PLAN,), extras=False)
        cs.phase_dryrun(proc, out, train["dryrun_card"], lm["outs"])
    torch.cuda.empty_cache()
    cs.phase_examples()
    cs.log(cs.smi_line())
    cs.log(f"dryrun_check: ok ({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
