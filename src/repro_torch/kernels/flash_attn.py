"""Causal GQA flash attention: Hopper kernel and plain version.

Replaces the TPU kernel `repro/kernels/flash_attn.py::flash_attention`:

    out (H, Sq, hd) = causal softmax(q k^T * hd^-0.5 [tanh-capped]) v

for q (H, Sq, hd) and k, v (Hkv, Skv, hd) with the batch folded into the
head axis and query head h reading kv head h // group (group = H / Hkv).
Positions are absolute from 0 on both axes (query i sees keys 0..i), as in
the TPU kernel. The kernel (`csrc/flash_attn.cu`; its bound and design are
stated there) keeps the TPU kernel's order: the float32 dot, the scale after
it, the optional tanh softcap, the -1e30 mask, the running (m, l, acc) in
float32, p rounded to v's dtype before the PV product. It takes head dims
64, 128 and 256 (the repo's configs), any Sq and Skv (the ragged edge is
masked in the kernel) and float32 or bfloat16.

The plain version follows `repro/kernels/ref.py::flash_attention`: one full
float32 softmax over the kv heads repeated `group` times; it does not round
p, so bfloat16 results differ from the kernel's by up to a few bf16 ulps.
Its two products follow PyTorch's float32 matmul precision setting (TF32
off by default). On a CPU tensor the wrapper runs the plain version; on a
CUDA tensor it launches the kernel or raises.

`row_error` is the reading the bfloat16 checks hold to a limit: under a
causal mask query row i averages i + 1 values, so its magnitude falls as
1 / sqrt(i + 1) (about 0.03 at row 4096 for unit-normal inputs) and one
absolute tolerance cannot fit both the first rows and the last.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (64, 128, 256)
NEG_INF = -1e30


def _check(q, k, v, group: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: expected q "
                         f"(H, Sq, hd) and k, v (Hkv, Skv, hd)")
    h, _, hd = q.shape
    hkv, skv, hd_k = k.shape
    if hd_k != hd or group < 1 or h != hkv * group:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match group={group} "
                         f"(H = Hkv * group, one head dim)")
    if skv == 0:
        raise ValueError("flash_attention: no keys (Skv = 0)")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q {q.dtype}, k {k.dtype}, v "
                         f"{v.dtype}; expected one dtype of {DTYPES}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, group: int = 1,
                          softcap: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of `flash_attention` (the reference's full
    softmax)."""
    _check(q, k, v, group)
    sq, hd = q.shape[1], q.shape[2]
    skv = k.shape[1]
    k_rep = k.repeat_interleave(group, dim=0).to(torch.float32)
    v_rep = v.repeat_interleave(group, dim=0).to(torch.float32)
    sc = torch.einsum("hqd,hkd->hqk", q.to(torch.float32), k_rep)
    sc = sc * (hd ** -0.5)
    if softcap > 0:
        sc = torch.tanh(sc / softcap) * softcap
    pos = torch.arange(max(sq, skv), device=q.device)
    mask = pos[:sq, None] >= pos[None, :skv]
    sc = torch.where(mask, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, v_rep).to(q.dtype)


def row_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest difference of ``got`` from ``want`` in any query row, over
    the root mean square of that row of ``want``."""
    g, w = got.to(torch.float32), want.to(torch.float32)
    rms = w.square().mean(-1).sqrt().clamp_min(1e-30)
    return float(((g - w).abs().amax(-1) / rms).max())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    group: int = 1, softcap: float = 0.0) -> torch.Tensor:
    """(H, Sq, hd) causal attention of q over k, v (Hkv, Skv, hd), query
    head h on kv head h // group, tanh softcap when ``softcap`` > 0; in q's
    dtype. Counts its kernel launches in ``flash_attention.launches``."""
    _check(q, k, v, group)
    if not _build.on_cuda(q, "flash_attention"):
        return flash_attention_plain(q, k, v, group=group, softcap=softcap)
    dev = q.device
    h, sq, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} has no kernel "
                         f"(head dims {HEAD_DIMS})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, q.dtype, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte aligned")
    out = torch.empty_like(q)
    if sq == 0:
        return out
    fn = _build.function("flash_attn", "repro_flash_attention", 4, 6, 2)
    rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            h, sq, k.shape[1], hd, group, int(q.dtype == torch.bfloat16),
            hd ** -0.5, float(softcap), _build.stream(dev))
    _build.check_launch(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
