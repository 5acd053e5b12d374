"""Causal GQA flash attention: Hopper kernels and plain versions.

Replaces the TPU kernel `repro/kernels/flash_attn.py::flash_attention`:

    out (H, Sq, hd) = causal softmax(q k^T * hd^-0.5 [tanh-capped]) v

for q (H, Sq, hd) and k, v (Hkv, Skv, hd) with the batch folded into the
head axis and query head h reading kv head h // group (group = H / Hkv).
Positions are absolute from 0 on both axes (query i sees keys 0..i), as in
the TPU kernel. Two wrappers launch one entry point of `csrc/flash_attn.cu`
(its bound and design are stated there) and count on one counter,
``flash_attention.launches``:

- `flash_attention(q, k, v, *, group, softcap)` takes the JAX contract's
  (H, S, hd) layout;
- `flash_attention_bshd(q, k, v, *, softcap)` takes the model's own layout,
  q (B, Sq, H, hd) and k, v (B, Skv, Hkv, hd), and returns (B, Sq, H, hd),
  so the model permutes and copies nothing around the call.

The kernels read each operand where it lies, through its strides: the last
axis must be contiguous and every other stride, like the data pointer, a
multiple of 16 bytes (the rule of the TMA copies); both wrappers raise
otherwise, on every device. The entry point dispatches on the dtype:
bfloat16 runs on the tensor cores (wgmma, K and V by TMA), float32 on the
CUDA cores, since the tensor cores would take float32 only as TF32 and
break the float32 parity below. A launch that fails raises
`KernelLaunchError`; nothing is retried on another kernel. Both keep the
TPU kernel's order: the float32 dot, the scale after it, the optional tanh
softcap, the mask, the running (m, l, acc) in float32, p rounded to v's
dtype before the PV product; the bfloat16 kernel takes exp2 with log2(e)
folded into the scale. They take head dims 64, 128 and 256 (the repo's
configs) and any Sq and Skv (the ragged edge is masked in the kernel).

The plain version follows `repro/kernels/ref.py::flash_attention`: one full
float32 softmax over the kv heads repeated `group` times; it does not round
p, so bfloat16 results differ from the kernel's by up to a few bf16 ulps.
Its two products follow PyTorch's float32 matmul precision setting (TF32
off by default). `flash_attention_bshd_plain` is the same behind a permute.
On a CPU tensor the wrappers run the plain versions; on a CUDA tensor they
launch the kernel or raise.

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
    _check_common(q, k, v, skv)


def _check_bshd(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_bshd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: expected q "
                         f"(B, Sq, H, hd) and k, v (B, Skv, Hkv, hd)")
    b, _, h, hd = q.shape
    b_k, skv, hkv, hd_k = k.shape
    if b_k != b or hd_k != hd or hkv < 1 or h % hkv:
        raise ValueError(f"flash_attention_bshd: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match (one batch, one "
                         f"head dim, H a multiple of Hkv)")
    _check_common(q, k, v, skv)


def _check_common(q, k, v, skv: int) -> None:
    if skv == 0:
        raise ValueError("flash_attention: no keys (Skv = 0)")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q {q.dtype}, k {k.dtype}, v "
                         f"{v.dtype}; expected one dtype of {DTYPES}")


def _check_layout(*named) -> None:
    """The kernels' rule for each operand: a contiguous last axis, every
    other stride and the data pointer a multiple of 16 bytes."""
    for name, t in named:
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s last axis is not "
                             f"contiguous (stride {t.stride(-1)})")
        size = t.element_size()
        for ax in range(t.dim() - 1):
            if t.shape[ax] > 1 and t.stride(ax) * size % 16:
                raise ValueError(
                    f"flash_attention: {name}'s stride {t.stride(ax)} on axis "
                    f"{ax} is not a multiple of 16 bytes")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned")


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


def flash_attention_bshd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *,
                               softcap: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of `flash_attention_bshd`: `flash_attention_plain`
    on the heads folded into the batch, (B·H, Sq, hd), query head b·H + h on
    kv head b·Hkv + h // group, and permuted back."""
    _check_bshd(q, k, v)
    b, sq, h, hd = q.shape

    def fold(t):
        return t.permute(0, 2, 1, 3).reshape(b * t.shape[2], t.shape[1], hd)

    out = flash_attention_plain(fold(q), fold(k), fold(v),
                                group=h // k.shape[2], softcap=softcap)
    return out.reshape(b, h, sq, hd).permute(0, 2, 1, 3)


def row_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest difference of ``got`` from ``want`` in any query row, over
    the root mean square of that row of ``want``."""
    g, w = got.to(torch.float32), want.to(torch.float32)
    rms = w.square().mean(-1).sqrt().clamp_min(1e-30)
    return float(((g - w).abs().amax(-1) / rms).max())


def _strides(t: torch.Tensor) -> list[int]:
    """(batch, seq, head) element strides of a (B, S, H, hd) operand; an
    axis of length 1 gets the tensor's size, a valid stride it never
    steps."""
    out = [t.stride(ax) if t.shape[ax] > 1 else t.numel() for ax in range(3)]
    if max(out) >= 2 ** 31:
        raise ValueError(f"flash_attention: strides {t.stride()} do not fit "
                         f"the kernel's 32-bit arguments")
    return out


def _launch(q, k, v, out, softcap: float) -> None:
    """One launch on (B, S, heads, hd) operands, the output ``out`` written
    in place."""
    dev = q.device
    b, sq, h, hd = q.shape
    _, skv, hkv, _ = k.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} has no kernel "
                         f"(head dims {HEAD_DIMS})")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"q on {dev}")
    if sq == 0:
        return
    fn = _build.function("flash_attn", "repro_flash_attention", 4, 19, 2)
    rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            b, h, hkv, sq, skv, hd, int(q.dtype == torch.bfloat16),
            *_strides(q), *_strides(k), *_strides(v), *_strides(out),
            hd ** -0.5, float(softcap), _build.stream(dev))
    _build.check_launch(rc, "flash_attention")
    flash_attention.launches += 1


def _bshd(t: torch.Tensor) -> torch.Tensor:
    """A (heads, S, hd) operand as the (1, S, heads, hd) view the kernel
    reads."""
    return t.unsqueeze(0).transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    group: int = 1, softcap: float = 0.0) -> torch.Tensor:
    """(H, Sq, hd) causal attention of q over k, v (Hkv, Skv, hd), query
    head h on kv head h // group, tanh softcap when ``softcap`` > 0; in q's
    dtype. Counts its kernel launches in ``flash_attention.launches``."""
    _check(q, k, v, group)
    _check_layout(("q", q), ("k", k), ("v", v))
    if not _build.on_cuda(q, "flash_attention"):
        return flash_attention_plain(q, k, v, group=group, softcap=softcap)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(_bshd(q), _bshd(k), _bshd(v), _bshd(out), softcap)
    return out


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, softcap: float = 0.0) -> torch.Tensor:
    """(B, Sq, H, hd) causal attention of q over k, v (B, Skv, Hkv, hd) in
    the model's layout, query head h on kv head h // (H / Hkv), tanh softcap
    when ``softcap`` > 0; in q's dtype, a new contiguous tensor. Counts its
    launches in ``flash_attention.launches``."""
    _check_bshd(q, k, v)
    _check_layout(("q", q), ("k", k), ("v", v))
    if not _build.on_cuda(q, "flash_attention"):
        return flash_attention_bshd_plain(q, k, v, softcap=softcap)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, softcap)
    return out


flash_attention.launches = 0
