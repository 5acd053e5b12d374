"""Mixed-precision dequantize-matmul: Hopper kernels and plain version.

Replaces the TPU kernel `repro/kernels/qmatmul.py::qmatmul` (with the
padding wrapper `repro/kernels/ops.py::qmatmul`):

    out (M, N) float32 = (x (M, K) @ w_q (K, N) int8) * scale (N,) float32

with the per-output-channel scale applied once to the finished sum. The
TPU kernel casts x to float32 whatever its type; here x is one of:

- uint8: the printed MLP's 8-bit input codes, on every path of the port.
  The kernel runs on the integer tensor cores (u8 x s8 -> s32, exact) and
  takes x's row stride, so x may be a column slice of a buffer whose rows
  are 16-byte aligned (`code_buffer`), which it then reads in 16-byte
  copies.
- float32 or bfloat16: the CUDA-core float32 FMA kernel. No path of the
  port calls it (the LM caller of the JAX package is not ported); it keeps
  the contract.

Both kernels live in `csrc/qmatmul.cu` (their bound and design are stated
there) and mask ragged M, K and N themselves. On the printed-MLP path
every partial sum is an integer below 2^24, so the kernels equal the plain
version exactly. The plain version accumulates in float64 and casts back,
so it does not depend on `torch.backends.cuda.matmul.allow_tf32`. On a
CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches a kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.runtime import trace

X_DTYPES = (torch.uint8, torch.float32, torch.bfloat16)
ROW_ALIGN = 16  # bytes: rows of a `code_buffer` start on this boundary


def code_buffer(codes: torch.Tensor) -> torch.Tensor:
    """(..., M, K) uint8 copy of integer ``codes`` (values in 0..255) whose
    rows start on 16-byte boundaries: a column slice of an (..., M, K
    rounded up to 16) buffer, which the uint8 kernel reads in 16-byte
    copies. The padding bytes are never read."""
    *lead, m, k = codes.shape
    k_pad = max(ROW_ALIGN, -(-k // ROW_ALIGN) * ROW_ALIGN)
    buf = torch.empty((*lead, m, k_pad), dtype=torch.uint8,
                      device=codes.device)
    buf[..., :k] = codes
    return buf[..., :k]


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
    """(M, N) float32 ``(x @ w_q) * scale``: x (M, K) uint8, float32 or
    bfloat16 (uint8 with unit column stride, float contiguous), w_q (K, N)
    int8, scale (N,) or (1, N) float32. Counts its kernel launches in
    ``launches.qmatmul``, and those of the float kernel among them in
    ``launches.qmatmul.float``."""
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
    if x.dtype == torch.uint8:
        if x.stride(1) != 1 or x.stride(0) < k:
            raise ValueError(f"x must have unit column stride and rows "
                             f"apart by at least K, got strides {x.stride()}")
    else:
        _build.require(x, "x", x.dtype, dev)
    _build.require(w_q, "w_q", torch.int8, dev)
    _build.require(scale, "scale", torch.float32, dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    if x.dtype == torch.uint8:
        fn = _build.function("qmatmul", "repro_qmatmul_u8", 4, 4)
        rc = fn(_build.ptr(x), _build.ptr(w_q), _build.ptr(scale),
                _build.ptr(out), m, n, k, x.stride(0), _build.stream(dev))
    else:
        fn = _build.function("qmatmul", "repro_qmatmul", 4, 4)
        rc = fn(_build.ptr(x), _build.ptr(w_q), _build.ptr(scale),
                _build.ptr(out), m, n, k, int(x.dtype == torch.bfloat16),
                _build.stream(dev))
    _build.check_launch(rc, "qmatmul")
    trace.count("launches.qmatmul")
    trace.count("launches.qmatmul.float", x.dtype != torch.uint8)
    return out


