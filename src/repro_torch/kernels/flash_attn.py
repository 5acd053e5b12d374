"""Causal GQA flash attention: Hopper kernels and plain versions.

Replaces the TPU kernel `repro/kernels/flash_attn.py::flash_attention`:

    out (H, Sq, hd) = causal softmax(q k^T * hd^-0.5 [tanh-capped]) v

for q (H, Sq, hd) and k, v (Hkv, Skv, hd) with the batch folded into the
head axis and query head h reading kv head h // group (group = H / Hkv).
Positions are absolute from 0 on both axes (query i sees keys 0..i), as in
the TPU kernel. Two wrappers launch one entry point of `csrc/flash_attn.cu`
(its bound and design are stated there) and count on one counter,
``launches.flash_attention``:

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
folded into the scale. They take head dims 64, 112, 128 and 256 (the
repo's configs; 112 runs the 128-wide kernels on tiles whose last 16
columns are zeros, 1.14x the exact product's work) and any Sq and Skv (the
ragged edge is masked in the kernel).

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
`grad_error` is its counterpart for the gradients.

The gradient. On a CUDA tensor that requires grad, both wrappers go
through a `torch.autograd.Function`: its forward launches the same kernel
with each query row's log-sum-exp kept (float32 (B, H, Sq), natural log),
its backward launches `flash_attention_backward`, two kernels of
`csrc/flash_attn_bwd.cu` (no TPU kernel: the JAX package differentiates its
jnp attention) counted on ``launches.flash_attention_backward``. Its plain
version `flash_attention_backward_plain` computes the same equations in
float32 PyTorch, and `flash_attention_lse_plain` the log-sum-exp; on the
CPU the wrappers run the plain forward and autograd differentiates it.
Without grad the wrappers launch the forward as before, keeping no
log-sum-exp. A backward that fails raises `KernelLaunchError`; nothing
falls back to autograd of the plain version.

On a meta tensor (the dry run, `launch.dryrun`) every wrapper takes its
card branch up to the launch: it allocates what the card allocates (the
output, the log-sum-exp, the backward's float32 scratch padded to 128
rows), launches nothing, counts no launch, and reports the call's FLOPs
(`kernels._build.report_flops`); the card branch reports the same number
when an analysis is active. A call's FLOPs are defined as what
`FlopCounterMode` counts on the CPU's path for it (`forward_flops`,
`backward_flops`), so meta, CPU and card counts agree. No path runs the
plain version on meta: its (Sq x Skv) scores would count as memory the
kernel never allocates. Any device but cuda, cpu and meta raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.runtime import trace

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (64, 112, 128, 256)
NEG_INF = -1e30


def forward_flops(q: torch.Tensor, k: torch.Tensor) -> int:
    """FLOPs of one forward call on model-layout q (B, Sq, H, hd) and k
    (B, Skv, Hkv, hd): what `FlopCounterMode` counts for the plain
    version's two products, the whole (Sq x Skv) scores and their product
    with v (no causal saving), 4·B·H·Sq·Skv·hd."""
    b, sq, h, hd = q.shape
    return 4 * b * h * sq * k.shape[1] * hd


def backward_flops(q: torch.Tensor, k: torch.Tensor) -> int:
    """FLOPs of one backward call: twice `forward_flops`, what autograd's
    backward of the plain forward's two products counts (both operands'
    gradients of each), the CPU's training path."""
    return 2 * forward_flops(q, k)


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


# `grad_error` holds a row to at least this share of the tensor's root mean
# square: a row whose true gradient is near zero (dq of query 0 is exactly
# zero: a softmax over one key) holds only the rounding of dP - D, whose
# size follows the tensor's scale, not the row's
GRAD_ERROR_FLOOR = 2.0 ** -4


def grad_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """`row_error` for a gradient: a row's largest difference over the
    larger of that row's root mean square in ``want`` and GRAD_ERROR_FLOOR
    times the whole tensor's."""
    g, w = got.to(torch.float32), want.to(torch.float32)
    rms = w.square().mean(-1).sqrt()
    rms = rms.clamp_min(float(w.square().mean().sqrt()) * GRAD_ERROR_FLOOR)
    return float(((g - w).abs().amax(-1) / rms.clamp_min(1e-30)).max())


def _strides(t: torch.Tensor) -> list[int]:
    """(batch, seq, head) element strides of a (B, S, H, hd) operand; an
    axis of length 1 gets the tensor's size, a valid stride it never
    steps."""
    out = [t.stride(ax) if t.shape[ax] > 1 else t.numel() for ax in range(3)]
    if max(out) >= 2 ** 31:
        raise ValueError(f"flash_attention: strides {t.stride()} do not fit "
                         f"the kernel's 32-bit arguments")
    return out


def _launch(q, k, v, out, softcap: float, lse=None) -> None:
    """One launch on (B, S, heads, hd) operands, the output ``out`` (and,
    when given, the float32 (B, heads, S) log-sum-exp ``lse``) written in
    place."""
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
    if _build.on_meta(q):
        _build.report_flops("flash_attention", forward_flops(q, k))
        return
    fn = _build.function("flash_attn", "repro_flash_attention", 5, 19, 2)
    rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            _build.ptr(lse) if lse is not None else None,
            b, h, hkv, sq, skv, hd, int(q.dtype == torch.bfloat16),
            *_strides(q), *_strides(k), *_strides(v), *_strides(out),
            hd ** -0.5, float(softcap), _build.stream(dev))
    _build.check_launch(rc, "flash_attention")
    trace.count("launches.flash_attention")
    if _build.FLOP_SINKS:
        _build.report_flops("flash_attention", forward_flops(q, k))


def _bshd(t: torch.Tensor) -> torch.Tensor:
    """A (heads, S, hd) operand as the (1, S, heads, hd) view the kernel
    reads."""
    return t.unsqueeze(0).transpose(1, 2)


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, softcap: float = 0.0):
    """(out, lse): `flash_attention_bshd` on CUDA model-layout operands with
    each query row's float32 (B, H, Sq) log-sum-exp kept, what the backward
    takes; one launch of the forward kernel, counted."""
    _check_bshd(q, k, v)
    _check_layout(("q", q), ("k", k), ("v", v))
    b, sq, h, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch(q, k, v, out, softcap, lse)
    return out, lse


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _Attention(torch.autograd.Function):
    """The kernel with its gradient, on (B, S, heads, hd) operands: the
    forward keeps each row's log-sum-exp, the backward launches
    `flash_attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, softcap: float):
        out, lse = flash_attention_forward(q, k, v, softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.softcap = softcap
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout,
                                              softcap=ctx.softcap)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    group: int = 1, softcap: float = 0.0) -> torch.Tensor:
    """(H, Sq, hd) causal attention of q over k, v (Hkv, Skv, hd), query
    head h on kv head h // group, tanh softcap when ``softcap`` > 0; in q's
    dtype. Counts its kernel launches in ``launches.flash_attention``; on
    the card, differentiable through `flash_attention_backward`."""
    _check(q, k, v, group)
    _check_layout(("q", q), ("k", k), ("v", v))
    if not _build.on_meta(q) and not _build.on_cuda(q, "flash_attention"):
        return flash_attention_plain(q, k, v, group=group, softcap=softcap)
    if _needs_grad(q, k, v):
        out = _Attention.apply(_bshd(q), _bshd(k), _bshd(v), softcap)
        return out[0].transpose(0, 1)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(_bshd(q), _bshd(k), _bshd(v), _bshd(out), softcap)
    return out


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, softcap: float = 0.0) -> torch.Tensor:
    """(B, Sq, H, hd) causal attention of q over k, v (B, Skv, Hkv, hd) in
    the model's layout, query head h on kv head h // (H / Hkv), tanh softcap
    when ``softcap`` > 0; in q's dtype, a new contiguous tensor. Counts its
    launches in ``launches.flash_attention``."""
    _check_bshd(q, k, v)
    _check_layout(("q", q), ("k", k), ("v", v))
    if not _build.on_meta(q) and not _build.on_cuda(q, "flash_attention"):
        return flash_attention_bshd_plain(q, k, v, softcap=softcap)
    if _needs_grad(q, k, v):
        return _Attention.apply(q, k, v, softcap)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, softcap)
    return out




# ---------------------------------------------------------------------------
# the gradient
# ---------------------------------------------------------------------------

def _scores_plain(q, k, softcap: float):
    """(u, s, mask) of the model-layout operands in float32, (B, H, Sq,
    Skv): the scaled dot, the (capped) score, and the causal mask."""
    sq, h, hd = q.shape[1:]
    g = h // k.shape[2]
    qf = q.to(torch.float32).permute(0, 2, 1, 3)
    kf = k.to(torch.float32).permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    u = (qf @ kf.transpose(-1, -2)) * (hd ** -0.5)
    s = torch.tanh(u / softcap) * softcap if softcap > 0 else u
    pos = torch.arange(max(sq, k.shape[1]), device=q.device)
    mask = pos[:sq, None] >= pos[None, :k.shape[1]]
    return u, s, mask


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor, *,
                              softcap: float = 0.0) -> torch.Tensor:
    """Each query row's natural-log log-sum-exp of its masked scores,
    float32 (B, H, Sq), for model-layout q (B, Sq, H, hd) and k (B, Skv,
    Hkv, hd): what the kernel's forward keeps for the backward."""
    _, s, mask = _scores_plain(q, k, softcap)
    return torch.logsumexp(torch.where(mask, s, NEG_INF), dim=-1)


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, o: torch.Tensor,
                                   lse: torch.Tensor, do: torch.Tensor, *,
                                   softcap: float = 0.0):
    """Plain float32 PyTorch version of `flash_attention_backward`: (dq,
    dk, dv) in the inputs' dtypes from the model-layout operands, the
    forward's output ``o`` and log-sum-exp ``lse`` (B, H, Sq), and the
    output's gradient ``do``:

        P = exp(s - lse) (0 where masked), D = rowsum(do * o),
        dV = P^T do, dP = do V^T,
        dS = P (dP - D) (1 - tanh^2(u / cap) with a cap) * hd^-0.5,
        dK = dS^T q, dQ = dS k,

    dK and dV summed over each kv head's query heads."""
    _check_bshd(q, k, v)
    b, _, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    u, s, mask = _scores_plain(q, k, softcap)

    def heads(t, rep=1):
        t = t.to(torch.float32).permute(0, 2, 1, 3)
        return t.repeat_interleave(rep, dim=1) if rep > 1 else t

    qf, kf, vf = heads(q), heads(k, g), heads(v, g)
    of, dof = heads(o), heads(do)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    d = (dof * of).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - d)
    if softcap > 0:
        ds = ds * (1.0 - torch.square(torch.tanh(u / softcap)))
    ds = ds * (hd ** -0.5)

    def kv_heads(t):   # (B, H, Skv, hd) -> (B, Skv, Hkv, hd), group summed
        return t.reshape(b, hkv, g, skv, hd).sum(2).permute(0, 2, 1, 3)

    dq = (ds @ kf).permute(0, 2, 1, 3)
    dk = kv_heads(ds.transpose(-1, -2) @ qf)
    dv = kv_heads(p.transpose(-1, -2) @ dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             softcap: float = 0.0):
    """(dq, dk, dv) of the causal attention in the model's layout: q, o, do
    (B, Sq, H, hd), k, v (B, Skv, Hkv, hd), lse the forward's float32 (B,
    H, Sq) log-sum-exp; new contiguous tensors in the inputs' dtype. On a
    CUDA tensor it launches the two kernels of `csrc/flash_attn_bwd.cu`
    (counted once in ``launches.flash_attention_backward``), on a CPU
    tensor it runs `flash_attention_backward_plain`."""
    _check_bshd(q, k, v)
    b, sq, h, hd = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_backward: o {tuple(o.shape)} and "
                         f"do {tuple(do.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_backward: lse {tuple(lse.shape)} "
                         f"{lse.dtype}, expected float32 {(b, h, sq)}")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_backward: o {o.dtype} and do "
                         f"{do.dtype} must be q's dtype {q.dtype}")
    if not _build.on_meta(q) and \
            not _build.on_cuda(q, "flash_attention_backward"):
        return flash_attention_backward_plain(q, k, v, o, lse, do,
                                              softcap=softcap)
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_backward: head dim {hd} has no "
                         f"kernel (head dims {HEAD_DIMS})")
    for name, t in (("k", k), ("v", v), ("o", o), ("lse", lse), ("do", do)):
        if t.device != q.device:
            raise ValueError(f"flash_attention_backward: {name} is on "
                             f"{t.device}, q on {q.device}")
    lse, do = lse.contiguous(), do.contiguous()
    _check_layout(("q", q), ("k", k), ("v", v), ("o", o), ("do", do))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if sq == 0:
        return dq, dk.zero_(), dv.zero_()
    # D and the log-sum-exp in log2 units of every query row, rows padded
    # to the query-tile kernel's 128 (csrc/flash_attn_bwd.cu, tc::padded)
    rows = -(-sq // 128) * 128
    scratch = torch.empty(2 * b * h * rows, dtype=torch.float32,
                          device=q.device)
    if _build.on_meta(q):
        _build.report_flops("flash_attention_backward",
                            backward_flops(q, k))
        return dq, dk, dv
    fn = _build.function("flash_attn_bwd", "repro_flash_attention_backward",
                         10, 22, 2)
    rc = fn(*(_build.ptr(t) for t in (q, k, v, o, lse, do, dq, dk, dv,
                                      scratch)),
            b, h, k.shape[2], sq, k.shape[1], hd,
            int(q.dtype == torch.bfloat16), *_strides(q), *_strides(k),
            *_strides(v), *_strides(o), *_strides(do), hd ** -0.5,
            float(softcap), _build.stream(q.device))
    _build.check_launch(rc, "flash_attention_backward")
    trace.count("launches.flash_attention_backward")
    if _build.FLOP_SINKS:
        _build.report_flops("flash_attention_backward", backward_flops(q, k))
    return dq, dk, dv


