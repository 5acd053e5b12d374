"""The port's `qmatmul`: the plain version held to `repro.kernels.ref.qmatmul`
on the CPU, and (on a CUDA machine) the Hopper kernel held to the plain
version.

Tolerances:
- integer codes (x in 0..255, the printed-MLP inputs, as float32 or as
  uint8; any int8 w): exact equality. Every partial sum is an integer below 2^24, exact in float32
  in any order and in the plain version's float64.
- float x (float32, or bfloat16, which widens to float32 exactly): rtol
  1e-5, atol 1e-3. The reference and the kernel accumulate in float32 in
  their own orders and the plain version in float64; with K <= 777 terms
  of magnitude <= 128 the float32 rounding stays far inside this.

The JAX package is imported by a fixture, not at the top: the machine with
the card has no JAX, and runs this file's card tests alone with
``python -m pytest -m torch_cuda tests/test_torch_qmatmul.py``.
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import qmatmul as t_qmm

RTOL, ATOL = 1e-5, 1e-3

SHAPES = [  # (M, K, N)
    (1, 561, 16),           # one served request of the har MLP
    (37, 7, 16),            # seeds-width layer 1, ragged M
    (300, 777, 515),        # ragged M, K and N
    (129, 130, 131),        # one past each tile edge
    (63, 16, 128),
    (129, 300, 32),         # the widest N of the narrow tile
    (65, 561, 33),          # one past it: the wide tile
]


@pytest.fixture(scope="module")
def jref():
    """The JAX package's reference (`ref.qmatmul`)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref
    return types.SimpleNamespace(jnp=jnp, ref=ref)


def _case(seed, m, k, n, kind):
    """numpy operands: "codes" = x in 0..255 with w in [-8, 7] and scale 1
    (the printed-MLP layer); "float" = random float32 x, int8 w over the
    full [-128, 127] and a random positive scale."""
    rng = np.random.default_rng(seed)
    if kind == "codes":
        x = rng.integers(0, 256, (m, k)).astype(np.float32)
        w = rng.integers(-8, 8, (k, n)).astype(np.int8)
        scale = np.ones(n, np.float32)
    else:
        x = rng.standard_normal((m, k)).astype(np.float32)
        w = rng.integers(-128, 128, (k, n)).astype(np.int8)
        scale = rng.uniform(0.001, 0.1, n).astype(np.float32)
    return x, w, scale


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("kind", ["codes", "float"])
def test_plain_matches_ref(jref, m, k, n, kind):
    x, w, scale = _case(m + k + n, m, k, n, kind)
    want = np.asarray(jref.ref.qmatmul(jref.jnp.asarray(x),
                                       jref.jnp.asarray(w),
                                       jref.jnp.asarray(scale[None, :])))
    got = t_qmm.qmatmul(torch.as_tensor(x), torch.as_tensor(w),
                        torch.as_tensor(scale))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    if kind == "codes":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_uint8_matches_ref(jref, m, k, n):
    """uint8 codes (the dtype the port's callers pass) through the plain
    version equal the reference on the same codes as float32, exactly."""
    x, w, scale = _case(m + k + n, m, k, n, "codes")
    want = np.asarray(jref.ref.qmatmul(jref.jnp.asarray(x),
                                       jref.jnp.asarray(w),
                                       jref.jnp.asarray(scale[None, :])))
    xu = torch.as_tensor(x.astype(np.uint8))
    for xin in (xu, t_qmm.code_buffer(xu)):
        got = t_ops.qmatmul(xin, torch.as_tensor(w), torch.as_tensor(scale))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,k", [(1, 561), (37, 7), (5, 16), (3, 0)])
def test_code_buffer_rows_are_aligned(m, k):
    codes = torch.as_tensor(np.random.default_rng(k).integers(
        0, 256, (m, k)).astype(np.int32))
    buf = t_qmm.code_buffer(codes)
    assert buf.dtype == torch.uint8 and buf.shape == (m, k)
    assert buf.stride(1) == 1 and buf.stride(0) % t_qmm.ROW_ALIGN == 0
    assert buf.stride(0) >= k
    assert torch.equal(buf.to(torch.int32), codes)


@pytest.mark.parametrize("m,k,n", [(37, 7, 16), (300, 777, 515)])
def test_plain_bfloat16_matches_ref(jref, m, k, n):
    """bfloat16 x widens to float32 exactly on both sides, so the float32
    tolerance holds."""
    x, w, scale = _case(3, m, k, n, "float")
    xb = torch.as_tensor(x).to(torch.bfloat16)
    want = np.asarray(jref.ref.qmatmul(
        jref.jnp.asarray(xb.to(torch.float32).numpy()).astype(
            jref.jnp.bfloat16),
        jref.jnp.asarray(w), jref.jnp.asarray(scale[None, :])))
    got = t_ops.qmatmul(xb, torch.as_tensor(w), torch.as_tensor(scale))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_plain_ignores_the_tf32_flag():
    """The plain version accumulates in float64: the TF32 flag (a no-op on
    the CPU, honoured by cuBLAS on the card) cannot change its result."""
    x, w, scale = _case(5, 64, 561, 32, "codes")
    args = [torch.as_tensor(a) for a in (x, w, scale)]
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        on = t_qmm.qmatmul_plain(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert torch.equal(on, t_qmm.qmatmul_plain(*args))


def test_scale_shapes_and_empty_operands():
    x, w, scale = _case(7, 9, 5, 4, "float")
    xt, wt, st = (torch.as_tensor(a) for a in (x, w, scale))
    assert torch.equal(t_qmm.qmatmul(xt, wt, st),
                       t_qmm.qmatmul(xt, wt, st[None, :]))
    assert t_qmm.qmatmul(xt[:0], wt, st).shape == (0, 4)
    assert torch.equal(t_qmm.qmatmul(xt[:, :0], wt[:0], st),
                       torch.zeros((9, 4)))


@pytest.mark.parametrize("bad", ["chain", "x_dtype", "w_dtype", "scale",
                                 "x_int8", "x_int32"])
def test_wrapper_refuses_bad_operands(bad):
    x = torch.zeros((4, 3))
    w = torch.zeros((3, 2), dtype=torch.int8)
    scale = torch.ones(2)
    if bad == "chain":
        w = torch.zeros((5, 2), dtype=torch.int8)
    elif bad == "x_dtype":
        x = x.to(torch.float64)
    elif bad == "x_int8":
        x = x.to(torch.int8)
    elif bad == "x_int32":
        x = x.to(torch.int32)
    elif bad == "w_dtype":
        w = w.to(torch.int32)
    elif bad == "scale":
        scale = torch.ones(3)
    with pytest.raises(ValueError):
        t_qmm.qmatmul(x, w, scale)


def test_registered_with_build_and_counters():
    """The source is built with the others and the wrapper is counted; a
    tensor on neither the CPU nor a GPU is refused, never run."""
    assert "qmatmul" in _build.SOURCES
    assert (_build.CSRC / "qmatmul.cu").exists()
    assert kernels.KERNEL_WRAPPERS["qmatmul"] is t_qmm.qmatmul
    kernels.reset_launch_counts()
    t_qmm.qmatmul(torch.zeros((2, 3)), torch.zeros((3, 2), dtype=torch.int8),
                  torch.ones(2))
    assert kernels.launch_counts()["qmatmul"] == 0  # the CPU runs the plain
    meta_x = torch.empty((2, 3), device="meta")
    meta_w = torch.empty((3, 2), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        t_qmm.qmatmul(meta_x, meta_w, torch.ones(2, device="meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.torch_cuda
class TestQmatmulOnCuda:
    """The Hopper kernel equals its plain version on the card."""

    @pytest.mark.parametrize("m,k,n", SHAPES + [(3090, 561, 8192),
                                                (1024, 561, 16)])
    def test_codes_exact(self, cuda_device, m, k, n):
        x, w, scale = (torch.as_tensor(a, device=cuda_device)
                       for a in _case(m + n, m, k, n, "codes"))
        launches = t_qmm.qmatmul.launches
        got = t_qmm.qmatmul(x, w, scale)
        torch.cuda.synchronize()
        assert t_qmm.qmatmul.launches == launches + 1
        assert torch.equal(got, t_qmm.qmatmul_plain(x, w, scale))

    @pytest.mark.parametrize("m,k,n", SHAPES + [
        (3090, 561, 8192),                 # the MLP fitness
        (1, 561, 16), (37, 561, 16), (1024, 561, 16), (3090, 561, 16)])
    @pytest.mark.parametrize("layout", ["contiguous", "code_buffer"])
    def test_uint8_codes_exact(self, cuda_device, m, k, n, layout):
        """The integer tensor-core kernel equals the plain version bit for
        bit at scale 1, on contiguous rows (byte loads) and on 16-byte
        aligned rows (16-byte copies)."""
        x, w, scale = _case(m + n, m, k, n, "codes")
        xu = torch.as_tensor(x.astype(np.uint8), device=cuda_device)
        if layout == "code_buffer":
            xu = t_qmm.code_buffer(xu)
        w, scale = (torch.as_tensor(a, device=cuda_device) for a in (w, scale))
        launches = t_qmm.qmatmul.launches
        got = t_qmm.qmatmul(xu, w, scale)
        torch.cuda.synchronize()
        assert t_qmm.qmatmul.launches == launches + 1
        assert torch.equal(got, t_qmm.qmatmul_plain(xu, w, scale))

    def test_uint8_refuses_strided_columns(self, cuda_device):
        x = torch.zeros((4, 6), dtype=torch.uint8, device=cuda_device)[:, ::2]
        w = torch.zeros((3, 2), dtype=torch.int8, device=cuda_device)
        with pytest.raises(ValueError, match="unit column stride"):
            t_qmm.qmatmul(x, w, torch.ones(2, device=cuda_device))

    @pytest.mark.parametrize("n", [515, 16])
    def test_uint8_random_scale(self, cuda_device, n):
        """Full int8 weights and a random scale: the kernel rounds once
        (float(int32 sum) * scale), within the module's tolerance."""
        rng = np.random.default_rng(n)
        xu = torch.as_tensor(rng.integers(0, 256, (300, 777)).astype(np.uint8),
                             device=cuda_device)
        w = torch.as_tensor(rng.integers(-128, 128, (777, n)).astype(np.int8),
                            device=cuda_device)
        scale = torch.as_tensor(rng.uniform(0.001, 0.1, n).astype(np.float32),
                                device=cuda_device)
        got = t_qmm.qmatmul(xu, w, scale)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, t_qmm.qmatmul_plain(xu, w, scale),
                                   rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("n", [515, 16])
    def test_float_within_tolerance(self, cuda_device, dtype, n):
        x, w, scale = (torch.as_tensor(a, device=cuda_device)
                       for a in _case(11, 300, 777, n, "float"))
        x = x.to(dtype)
        got = t_qmm.qmatmul(x, w, scale)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, t_qmm.qmatmul_plain(x, w, scale),
                                   rtol=RTOL, atol=ATOL)

    def test_exact_with_tf32_allowed(self, cuda_device):
        """Neither the kernel nor the plain version goes through TF32."""
        x, w, scale = (torch.as_tensor(a, device=cuda_device)
                       for a in _case(13, 3090, 561, 512, "codes"))
        before = torch.backends.cuda.matmul.allow_tf32
        try:
            torch.backends.cuda.matmul.allow_tf32 = True
            got = t_qmm.qmatmul(x, w, scale)
            plain = t_qmm.qmatmul_plain(x, w, scale)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before
        torch.cuda.synchronize()
        assert torch.equal(got, plain)
        assert torch.equal(got, t_qmm.qmatmul_plain(x, w, scale))
