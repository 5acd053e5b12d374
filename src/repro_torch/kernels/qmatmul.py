"""Mixed-precision dequantize-matmul: Hopper kernel and plain version.

Replaces the TPU kernel `repro/kernels/qmatmul.py::qmatmul` (with the
padding wrapper `repro/kernels/ops.py::qmatmul`):

    out (M, N) float32 = (x (M, K) float32|bfloat16 @ w_q (K, N) int8)
                         * scale (N,) float32

with float32 accumulation over K and the per-output-channel scale applied
once to the finished sum. The kernel (`csrc/qmatmul.cu`; its bound and
design are stated there) masks ragged M, K and N itself, so nothing is
padded. On the printed-MLP path x holds 8-bit input codes and w_q small
integers, every partial sum is an integer below 2^24, and the result is
exact whatever the summation order; the plain version then equals the
kernel exactly. The plain version accumulates in float64 and casts back,
so it does not depend on `torch.backends.cuda.matmul.allow_tf32`. On a CPU
tensor the wrapper runs the plain version; on a CUDA tensor it launches
the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

X_DTYPES = (torch.float32, torch.bfloat16)


def _scale_vector(scale: torch.Tensor, n: int) -> torch.Tensor:
    """(N,) or (1, N) scale -> (N,); anything else raises."""
    if tuple(scale.shape) not in ((n,), (1, n)):
        raise ValueError(f"scale has shape {tuple(scale.shape)}, expected "
                         f"({n},) or (1, {n})")
    return scale.reshape(n)


def qmatmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `qmatmul`, in float64."""
    s = _scale_vector(scale, w_q.shape[1]).to(torch.float64)
    return ((x.to(torch.float64) @ w_q.to(torch.float64)) * s).to(
        torch.float32)


def qmatmul(x: torch.Tensor, w_q: torch.Tensor,
            scale: torch.Tensor) -> torch.Tensor:
    """(M, N) float32 ``(x @ w_q) * scale``: x (M, K) float32 or bfloat16,
    w_q (K, N) int8, scale (N,) or (1, N) float32. Counts its kernel
    launches in ``qmatmul.launches``."""
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"qmatmul: x {tuple(x.shape)} and w_q "
                         f"{tuple(w_q.shape)} do not chain as (M, K) @ (K, N)")
    if x.dtype not in X_DTYPES or w_q.dtype != torch.int8:
        raise ValueError(f"qmatmul: x {x.dtype} and w_q {w_q.dtype}, "
                         f"expected x in {X_DTYPES} and w_q torch.int8")
    if not _build.on_cuda(x, "qmatmul"):
        return qmatmul_plain(x, w_q, scale)
    dev = x.device
    m, k = x.shape
    n = w_q.shape[1]
    scale = _scale_vector(scale, n)
    _build.require(x, "x", x.dtype, dev)
    _build.require(w_q, "w_q", torch.int8, dev)
    _build.require(scale, "scale", torch.float32, dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    fn = _build.function("qmatmul", "repro_qmatmul", 4, 4)
    rc = fn(_build.ptr(x), _build.ptr(w_q), _build.ptr(scale), _build.ptr(out),
            m, n, k, int(x.dtype == torch.bfloat16), _build.stream(dev))
    _build.check_launch(rc, "qmatmul")
    qmatmul.launches += 1
    return out


qmatmul.launches = 0
