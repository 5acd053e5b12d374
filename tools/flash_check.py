#!/usr/bin/env python3
"""Check and time the port's `flash_attention` kernels on one CUDA card.

    python3 tools/flash_check.py           # from the repository root

Builds `src/repro_torch/csrc/flash_attn.cu` alone, prints nvcc's registers
and spills for each kernel, holds both wrappers to their plain versions
(bfloat16 by `row_error` within 2^-4, float32 within 2e-5, the limits of
`tests/test_torch_flash.py`) on random inputs, and, within two bf16 ulps of
each row's largest element, on q = k = 0 (every score equal: row i is the
mean of v's first i + 1 rows, which reads the PV product and the mask
alone) and on a one-hot v (row i holds key j's probability in column
j mod hd, which reads the score product alone), in the
(H, S, hd) layout and in the model's (B, S, H, hd) layout, contiguous and
as views into one fused qkv tensor; then times the LM prefill shape
(llama3.2-3b at B=4, S=4096) through the model-layout wrapper beside its
plain version, `scaled_dot_product_attention` and the bound. It is the
quick check of the kernel between runs of `chip_smoke.py`, which holds the
same limits. Exits 1 on the first failed check.
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

PEAK_TOL = 2.0 ** -7
CASES = [  # (B, H, Hkv, Sq, Skv, hd, dtype, softcap)
    (1, 8, 4, 512, 512, 64, torch.float32, 0.0),
    (2, 16, 4, 333, 333, 128, torch.float32, 0.0),
    (1, 8, 1, 200, 517, 256, torch.float32, 0.0),
    (1, 24, 8, 1000, 1000, 128, torch.bfloat16, 0.0),
    (2, 8, 8, 256, 256, 64, torch.bfloat16, 30.0),
    (1, 8, 1, 1000, 1000, 256, torch.bfloat16, 0.0),
    (3, 6, 2, 777, 777, 64, torch.bfloat16, 0.0),
    (2, 4, 2, 300, 900, 128, torch.bfloat16, 0.0),
    (1, 4, 2, 1, 1, 128, torch.bfloat16, 0.0),
    (4, 24, 8, 4096, 4096, 128, torch.bfloat16, 0.0),
]


def inputs(rng, kind, b, h, hkv, sq, skv, hd, dtype, fused):
    """q (B, Sq, H, hd), k, v (B, Skv, Hkv, hd) on the card: ``kind``
    'random', 'uniform' (q = k = 0) or 'one-hot' (v[j] = e_(j mod hd));
    ``fused`` makes them views into one (B, S, H + 2 Hkv, hd) tensor."""
    if fused and sq == skv:
        qkv = torch.as_tensor(rng.standard_normal(
            (b, sq, h + 2 * hkv, hd), dtype=np.float32), device="cuda")
        qkv = qkv.to(dtype)
        q, k, v = qkv.split([h, hkv, hkv], dim=2)
    else:
        q, k, v = (torch.as_tensor(rng.standard_normal(
            (b, s, n, hd), dtype=np.float32), device="cuda").to(dtype)
            for s, n in ((sq, h), (skv, hkv), (skv, hkv)))
    if kind == "uniform":
        q, k = q.zero_(), k.zero_()
    elif kind == "one-hot":
        eye = torch.eye(hd, device="cuda", dtype=dtype)
        v.copy_(eye[torch.arange(skv, device="cuda") % hd][None, :, None]
                .expand_as(v))
    return q, k, v


def check_case(rng, kind, layout, case) -> float:
    from repro_torch.kernels import flash_attn as fa

    b, h, hkv, sq, skv, hd, dtype, cap = case
    q, k, v = inputs(rng, kind, b, h, hkv, sq, skv, hd, dtype,
                     layout == "fused")
    if layout == "heads":   # (B·H, S, hd), contiguous
        q, k, v = (t.permute(0, 2, 1, 3).reshape(-1, t.shape[1], hd)
                   .contiguous() for t in (q, k, v))
        got = fa.flash_attention(q, k, v, group=h // hkv, softcap=cap)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, group=h // hkv,
                                        softcap=cap)
    else:
        got = fa.flash_attention_bshd(q, k, v, softcap=cap)
        torch.cuda.synchronize()
        want = fa.flash_attention_bshd_plain(q, k, v, softcap=cap)
    where = (f"{kind} {layout} B={b} H={h} Hkv={hkv} Sq={sq} Skv={skv} "
             f"hd={hd} {str(dtype)[6:]} softcap={cap}")
    cs.check(bool(torch.isfinite(got).all()), f"{where}: non-finite output")
    if dtype == torch.float32:
        e = float((got - want).abs().max())
        cs.check(torch.allclose(got, want, rtol=cs.FLASH_F32_TOL,
                                atol=cs.FLASH_F32_TOL),
                 f"{where}: differs by {e}")
        text = f"largest difference {e:.3g}"
    elif kind == "random":
        e = fa.row_error(got, want)
        cs.check(e <= cs.FLASH_BF16_ROW_TOL, f"{where}: row error {e}")
        text = f"row error {e:.4f}"
    else:
        # rows of probabilities are far from the random rows' spread (a
        # largest element near four times the rms) that `row_error`'s limit
        # assumes: hold each row to two bf16 ulps of its largest element
        g, w = got.float(), want.float()
        e = float(((g - w).abs().amax(-1) / w.abs().amax(-1)
                   .clamp_min(1e-30)).max())
        cs.check(e <= PEAK_TOL, f"{where}: peak error {e}")
        text = f"peak error {e:.4f}"
    cs.log(f"[check] {where}: {text}")
    return e


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attn as fa

    seconds = _build.build(("flash_attn",))
    cs.log(f"[build] flash_attn {seconds:.1f} s")
    for row in cs.ptxas_kernels("flash_attn"):
        cs.log(f"[build] {row}")
    warn = [ln for ln in _build.build_log("flash_attn").splitlines()
            if "warning" in ln.lower() or "Performance Loss" in ln]
    for ln in warn:
        cs.log(f"[build] {ln.strip()}")
    rng = np.random.default_rng(0)
    for case in CASES:
        for kind in ("uniform", "one-hot", "random"):
            if case[3] == 4096 and kind != "random":
                continue
            for layout in ("heads", "model", "fused"):
                check_case(rng, kind, layout, case)

    b, h, hkv, s, hd = 4, 24, 8, 4096, 128
    q, k, v = (torch.as_tensor(rng.standard_normal((b, s, n, hd),
                                                   dtype=np.float32),
                               device="cuda").to(torch.bfloat16)
               for n in (h, hkv, hkv))
    one = fa.flash_attention_bshd(q, k, v)
    cs.check(torch.equal(one, fa.flash_attention_bshd(q, k, v)),
             "two launches on the same inputs differ")
    ms, plain_ms, text = cs.timed(
        lambda: fa.flash_attention_bshd(q, k, v),
        lambda: fa.flash_attention_bshd_plain(q, k, v),
        "flash_attn", reps=20, plain_reps=2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms, lib_how = cs.device_or_stream_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    n_ops = 4 * cs.attention_pairs(s, s) * hd * h * b
    n_bytes = 2 * (2 * h + 2 * hkv) * b * s * hd
    bms, by = cs.bound(n_bytes, n_ops, cs.BF16_OPS_PER_S)
    cs.log(f"[time] B={b} H={h} Hkv={hkv} S={s} hd={hd} bf16: {text}; "
           f"scaled_dot_product_attention {lib_ms:.4f} ms {lib_how}; bound "
           f"{bms:.4f} ms ({by}); kernel {n_ops / ms / 1e9:.1f} TFLOP/s, "
           f"{ms / lib_ms:.2f}x SDPA, {ms / bms:.2f}x the bound")
    cs.log("[done] all checks passed")


if __name__ == "__main__":
    main()
