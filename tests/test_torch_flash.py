"""The port's `flash_attention`: the plain version held to
`repro.kernels.ref.flash_attention` and the port's prefill attention held to
`repro.models.attention.chunked_prefill_attention` on the CPU, and (on a
CUDA machine) the Hopper kernel held to the plain version.

Tolerances:
- float32: rtol = atol = 2e-5, as `tests/test_kernels.py` holds the Pallas
  kernel to the same reference. Both sides take float32 dots and a float32
  softmax in their own summation orders (full softmax against chunked
  online softmax for the model function).
- bfloat16: `flash_attn.row_error` (a row's largest difference over that
  row's root mean square) at most 2^-4, two bf16 ulps of a row's largest
  element at four times its root mean square. The kernel rounds p to
  bfloat16 before the PV product (as the TPU kernel does) and the plain
  version does not; both round the output to bfloat16. One absolute
  tolerance would not do: the rows' magnitudes fall as 1 / sqrt(row), to
  about 0.03 at row 4096. `test_row_error_limit_separates_planted_faults`
  holds the limit between a float32 emulation of the kernel's tiled order
  (reading 0.027 at S=4096) and the same emulation with a fault planted in
  the second half of the rows (0.13 for p rounded to float8, 0.59 to 15
  for the others), where the median output is 0.020.

The gradient (`flash_attention_backward`, its plain version and the
wrappers' autograd Function): the plain backward equals autograd of the
plain forward and `jax.vjp` of the JAX package's chunked attention within
1e-5 (float32, GQA groups 2 to 4, with and without a softcap). On the card
the kernels are held to the plain backward by `flash_attn.grad_error` (a
row error whose near-zero rows are held to 2^-4 of the tensor's scale) at
`chip_smoke.flash_bwd_cases`, by `chip_smoke.check_flash_backward`:
float32 within 2^-12, bfloat16 within 2^-4 (`chip_smoke.py` states why).
`test_grad_error_limits_separate_planted_faults` holds both limits, at the
inputs of the card's cases whose scores reach the cap (softcap 5, q x
2.5), between a float64 computation of the equations (for bf16 inputs,
with P and dS rounded to bf16 as the kernel rounds its operands) and the
same computation with one fault planted (D dropped; the softcap's
derivative dropped), 1.5 limits from each;
`test_float32_limit_passes_a_second_float32_backward` holds a second sound
float32 computation within the float32 limit by the same margin.

The JAX package is imported by a fixture, not at the top: the machine with
the card has no JAX, and runs this file's card tests alone with
``python -m pytest -m torch_cuda tests/test_torch_flash.py``.
"""
from __future__ import annotations

import pathlib
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (the card's cases, limits, checks)
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attn as t_fa  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402

F32_TOL = 2e-5
BF16_ROW_TOL = 2.0 ** -4
BWD_TOL = 1e-5                 # the plain backward against autograd / JAX


@pytest.fixture(scope="module")
def jref():
    """The JAX package's reference and its model attention."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref
    from repro.models import attention
    return types.SimpleNamespace(jnp=jnp, ref=ref, attention=attention)


def _qkv(seed, h, hkv, sq, skv, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(h, sq, hd)).astype(np.float32),
            rng.normal(size=(hkv, skv, hd)).astype(np.float32),
            rng.normal(size=(hkv, skv, hd)).astype(np.float32))


@pytest.mark.parametrize("sq,skv,hd,group", [
    (256, 256, 64, 1), (512, 512, 128, 4), (256, 512, 64, 2),
    (256, 256, 112, 1),                  # zamba2-7b's head dim
])
def test_plain_matches_ref(jref, sq, skv, hd, group):
    """The shapes of `tests/test_kernels.py`'s flash attention test."""
    hkv = 4
    q, k, v = _qkv(sq + skv + hd, hkv * group, hkv, sq, skv, hd)
    want = np.asarray(jref.ref.flash_attention(
        jref.jnp.asarray(q), jref.jnp.asarray(k), jref.jnp.asarray(v),
        group=group))
    got = t_fa.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v), group=group)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_plain_bf16_and_softcap_match_ref(jref):
    q, k, v = _qkv(5, 2, 2, 256, 256, 64)
    qb, kb, vb = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v))
    want = jref.ref.flash_attention(
        *(jref.jnp.asarray(t.to(torch.float32).numpy()).astype(
            jref.jnp.bfloat16) for t in (qb, kb, vb)),
        group=1, softcap=30.0)
    got = t_fa.flash_attention(qb, kb, vb, group=1, softcap=30.0)
    assert got.dtype == torch.bfloat16
    assert t_fa.row_error(got, torch.as_tensor(
        np.asarray(want, np.float32))) <= BF16_ROW_TOL


# (query tile, key tile) of the kernels: the float32 kernel's, and the
# bfloat16 tensor-core kernel's at hd 64/128 and at hd 256
KERNEL_TILES = [(64, 32), (128, 128), (128, 64)]


def _tiled(q, k, v, group, fault="none", late=0, bq=64, bk=32):
    """A float32 emulation of a kernel's order (``bq``-query blocks walking
    ``bk``-key tiles, running (m, l, acc), p rounded to v's dtype before the
    PV product), with one fault planted in the query rows at or past
    ``late``."""
    h, sq, hd = q.shape
    kr = k.repeat_interleave(group, 0).float()
    vr = v.repeat_interleave(group, 0).float()
    m = torch.full((h, sq), t_fa.NEG_INF)
    l = torch.zeros((h, sq))
    acc = torch.zeros((h, sq, hd))
    qpos = torch.arange(sq)[:, None]
    hit = qpos >= late
    for k0 in range(0, k.shape[1], bk):
        s = torch.einsum("hqd,hkd->hqk", q.float(), kr[:, k0:k0 + bk])
        s = s * hd ** -0.5
        kpos = torch.arange(k0, min(k0 + bk, k.shape[1]))[None, :]
        keep = qpos >= kpos
        if fault == "drop_diagonal_tile":   # the loop ends one tile early
            keep &= ~(hit & (kpos // bk == (qpos // bq * bq + bq - 1) // bk))
        elif fault == "drop_diagonal_key":  # q_pos > k_pos
            keep &= ~(hit & (qpos == kpos))
        s = torch.where(keep, s, t_fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        m = m_new
        pr = p.to(v.dtype).float()
        if fault == "p_float8":
            pr = torch.where(hit, p.to(torch.float8_e4m3fn).float(), pr)
        keep_acc = hit & (k0 > 0) if fault == "no_rescale" else None
        a = alpha if keep_acc is None else torch.where(keep_acc[:, 0], 1.0,
                                                        alpha)
        acc = acc * a[..., None] + torch.einsum("hqk,hkd->hqd", pr,
                                                vr[:, k0:k0 + bk])
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


@pytest.fixture(scope="module")
def main_length_rows():
    """Three query heads on one kv head at the LM prefill's length and head
    dim (S=4096, hd=128, bf16), with the plain version's output."""
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16)
               for a in _qkv(0, 3, 1, 4096, 4096, 128))
    return q, k, v, t_fa.flash_attention_plain(q, k, v, group=3)


@pytest.mark.parametrize("bq,bk", KERNEL_TILES)
@pytest.mark.parametrize("fault", ["none", "no_rescale", "drop_diagonal_tile",
                                   "drop_diagonal_key", "p_float8"])
def test_row_error_limit_separates_planted_faults(main_length_rows, fault,
                                                  bq, bk):
    """The bf16 limit passes each kernel's order and fails a kernel whose
    fault shows only in the second half of the rows, where most outputs are
    smaller than 0.05."""
    q, k, v, want = main_length_rows
    got = _tiled(q, k, v, 3, fault, late=q.shape[1] // 2, bq=bq, bk=bk)
    assert float(want[:, q.shape[1] // 2:].float().abs().median()) < 0.05
    err = t_fa.row_error(got, want)
    if fault == "none":
        assert err <= BF16_ROW_TOL / 1.5
    else:
        assert err >= 1.5 * BF16_ROW_TOL, err


@pytest.mark.parametrize("b,s,kv,g,hd,softcap", [
    (2, 64, 2, 2, 16, 0.0),      # reduced llama: GQA group 2
    (1, 128, 1, 4, 32, 30.0),    # MQA with grok's softcap
    (2, 1024, 2, 1, 16, 0.0),    # two JAX chunks of 512
    (1, 256, 2, 1, 112, 0.0),    # zamba2-7b: hd 112, no GQA grouping
])
def test_prefill_attention_matches_jax(jref, b, s, kv, g, hd, softcap):
    """The model layout (B, S, KV, G, hd), read where it lies, equals the
    JAX package's chunked online softmax."""
    rng = np.random.default_rng(b * s + g)
    q = rng.normal(size=(b, s, kv, g, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    cfg = reduced_config(get_config("llama3.2-3b"))
    want = np.asarray(jref.attention.chunked_prefill_attention(
        cfg, *(jref.jnp.asarray(a) for a in (q, k, v)), chunk=min(512, s),
        softcap=softcap))
    got = t_attn.chunked_prefill_attention(
        *(torch.as_tensor(a) for a in (q, k, v)), softcap=softcap)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_ragged_lengths_mask_as_absolute_positions():
    """Sq != Skv (JAX's chunked function accepts neither a ragged S nor
    this): query i sees keys 0..i, so keys past Sq change nothing and a
    shorter key axis is a prefix of the longer one."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(9, 4, 2, 100, 333, 16))
    full = t_fa.flash_attention_plain(q, k, v, group=2)
    cut = t_fa.flash_attention_plain(q, k[:, :100], v[:, :100], group=2)
    torch.testing.assert_close(full, cut, rtol=F32_TOL, atol=F32_TOL)
    # row 0 attends to key 0 alone
    torch.testing.assert_close(full[:, 0], v.repeat_interleave(2, 0)[:, 0])


@pytest.mark.parametrize("bad", ["rank", "group", "head_dim", "dtype",
                                 "mixed", "no_keys", "last_axis", "stride16"])
def test_wrapper_refuses_bad_operands(bad):
    """Shapes and dtypes the function does not take, and layouts the kernels
    do not read: a strided last axis, a stride that is not a multiple of 16
    bytes (the TMA copies' rule), refused on every device."""
    q, k, v = (torch.zeros((4, 8, 16)), torch.zeros((2, 8, 16)),
               torch.zeros((2, 8, 16)))
    group = 2
    if bad == "rank":
        q = q[None]
    elif bad == "group":
        group = 3
    elif bad == "head_dim":
        k = v = torch.zeros((2, 8, 32))
    elif bad == "dtype":
        q, k, v = (t.to(torch.float64) for t in (q, k, v))
    elif bad == "mixed":
        v = v.to(torch.bfloat16)
    elif bad == "no_keys":
        k = v = torch.zeros((2, 0, 16))
    elif bad == "last_axis":
        k = torch.zeros((2, 16, 8)).transpose(1, 2)
    else:   # rows 17 floats = 68 bytes apart
        v = torch.zeros((2, 8, 17))[..., :16]
    with pytest.raises(ValueError):
        t_fa.flash_attention(q, k, v, group=group)


@pytest.mark.parametrize("bad", ["rank", "batch", "heads", "head_dim",
                                 "last_axis", "stride16"])
def test_bshd_wrapper_refuses_bad_operands(bad):
    q, k, v = (torch.zeros((2, 8, 4, 16)), torch.zeros((2, 8, 2, 16)),
               torch.zeros((2, 8, 2, 16)))
    if bad == "rank":
        q = q[0]
    elif bad == "batch":
        k = v = torch.zeros((1, 8, 2, 16))
    elif bad == "heads":     # 4 query heads on 3 kv heads
        k = v = torch.zeros((2, 8, 3, 16))
    elif bad == "head_dim":
        q = torch.zeros((2, 8, 4, 32))
    elif bad == "last_axis":
        q = torch.zeros((2, 8, 16, 4)).transpose(2, 3)
    else:   # heads 18 floats = 72 bytes apart
        q = torch.zeros((2, 8, 4, 18))[..., :16]
    with pytest.raises(ValueError):
        t_fa.flash_attention_bshd(q, k, v)


def test_bshd_plain_is_plain_on_permuted_copies():
    """The model-layout plain version is the (H, S, hd) plain version on the
    heads folded into the batch, exactly: query head b·H + h on kv head
    b·Hkv + h // G."""
    rng = np.random.default_rng(11)
    b, sq, skv, h, hkv, hd = 3, 50, 70, 6, 2, 16
    q = torch.as_tensor(rng.normal(size=(b, sq, h, hd)), dtype=torch.float32)
    k = torch.as_tensor(rng.normal(size=(b, skv, hkv, hd)),
                        dtype=torch.float32)
    v = torch.as_tensor(rng.normal(size=(b, skv, hkv, hd)),
                        dtype=torch.float32)
    got = t_fa.flash_attention_bshd(q, k, v, softcap=20.0)
    assert got.shape == q.shape
    want = t_fa.flash_attention_plain(
        *(t.permute(0, 2, 1, 3).contiguous().reshape(-1, t.shape[1], hd)
          for t in (q, k, v)), group=h // hkv, softcap=20.0)
    assert torch.equal(got, want.reshape(b, h, sq, hd).permute(0, 2, 1, 3))


def test_kernel_operand_strides():
    """The (batch, seq, head) element strides each launch passes: the
    (H, S, hd) contract as batch 1 (head stride S·hd), the model's layout
    as it lies (a view into a fused qkv tensor too); an axis of length 1
    gets a stride it never steps."""
    h, s, hd = 6, 10, 64
    assert t_fa._strides(t_fa._bshd(torch.zeros((h, s, hd)))) == [
        h * s * hd, hd, s * hd]
    qkv = torch.zeros((2, s, h + 4, hd))
    q, k, _ = qkv.split([h, 2, 2], dim=2)
    assert t_fa._strides(q) == t_fa._strides(k) == [
        s * (h + 4) * hd, (h + 4) * hd, hd]
    assert t_fa._strides(torch.zeros((1, 1, 1, hd))) == [hd] * 3


class _Elsewhere(torch.Tensor):
    """A meta tensor that reports a device the port has no branch for."""

    @property
    def device(self):
        return torch.device("xpu")


def _elsewhere(shape) -> torch.Tensor:
    return torch.Tensor._make_subclass(_Elsewhere,
                                       torch.empty(shape, device="meta"))


def test_registered_with_build_and_counters():
    """The source is built with the others and the wrapper is counted; a
    meta tensor takes the dry run's meta branch (no launch counted); a
    tensor on neither the CPU, a GPU nor meta is refused, never run."""
    assert "flash_attn" in _build.SOURCES
    assert (_build.CSRC / "flash_attn.cu").exists()
    assert kernels.KERNEL_WRAPPERS["flash_attention"] is t_fa.flash_attention
    kernels.reset_launch_counts()
    q = torch.zeros((2, 4, 64))
    t_fa.flash_attention(q, q, q)
    assert kernels.launch_counts()["flash_attention"] == 0  # CPU: the plain
    meta = torch.empty((2, 4, 64), device="meta")
    assert t_fa.flash_attention(meta, meta, meta).is_meta
    assert kernels.launch_counts()["flash_attention"] == 0
    other = _elsewhere((2, 4, 64))
    with pytest.raises(ValueError, match="unsupported device"):
        t_fa.flash_attention(other, other, other)


# ---------------------------------------------------------------------------
# the gradient
# ---------------------------------------------------------------------------

BWD_CASES = [  # (b, s, kv, g, hd, softcap)
    (2, 64, 2, 2, 16, 0.0),      # reduced llama: GQA group 2
    (1, 128, 1, 4, 32, 30.0),    # MQA with grok's softcap
    (2, 64, 2, 3, 16, 2.0),      # a cap the scores reach
]


def _bshd_inputs(seed, b, s, kv, g, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, kv, g, hd)).astype(np.float32),
            rng.normal(size=(b, s, kv, hd)).astype(np.float32),
            rng.normal(size=(b, s, kv, hd)).astype(np.float32),
            rng.normal(size=(b, s, kv, g, hd)).astype(np.float32))


@pytest.mark.parametrize("b,s,kv,g,hd,softcap", BWD_CASES)
def test_backward_plain_matches_autograd_and_jax(jref, b, s, kv, g, hd,
                                                 softcap):
    """`flash_attention_backward_plain` from the forward's output and
    log-sum-exp equals autograd of the plain forward and `jax.vjp` of the
    JAX package's `chunked_prefill_attention` (what the JAX package trains
    through), dq of the grouped query heads and dk, dv summed over each kv
    head's group."""
    import jax

    q, k, v, do = _bshd_inputs(b + s + g, b, s, kv, g, hd)
    qt, kt, vt = (torch.as_tensor(a).requires_grad_(True) for a in (q, k, v))
    q4 = qt.reshape(b, s, kv * g, hd)
    out = t_fa.flash_attention_bshd(q4, kt, vt, softcap=softcap)
    do4 = torch.as_tensor(do).reshape(b, s, kv * g, hd)
    out.backward(do4)
    lse = t_fa.flash_attention_lse_plain(q4.detach(), kt.detach(),
                                         softcap=softcap)
    got = t_fa.flash_attention_backward_plain(
        q4.detach(), kt.detach(), vt.detach(), out.detach(), lse, do4,
        softcap=softcap)
    assert [t.shape for t in got] == [q4.shape, kt.shape, vt.shape]
    for a, w in zip(got, (qt.grad.reshape(q4.shape), kt.grad, vt.grad)):
        torch.testing.assert_close(a, w, rtol=BWD_TOL, atol=BWD_TOL)
    cfg = reduced_config(get_config("llama3.2-3b"))
    _, vjp = jax.vjp(lambda a, c, e: jref.attention.chunked_prefill_attention(
        cfg, a, c, e, chunk=min(512, s), softcap=softcap),
        *(jref.jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jref.jnp.asarray(do))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.reshape(w.shape).numpy(), np.asarray(w),
                                   rtol=BWD_TOL, atol=BWD_TOL)


def test_lse_plain_is_the_forward_normaliser():
    """exp(s - lse) sums to one over each row's visible keys, and row 0's
    log-sum-exp is its one score."""
    q, k, _, _ = _bshd_inputs(1, 2, 40, 2, 2, 16)
    q4 = torch.as_tensor(q).reshape(2, 40, 4, 16)
    kt = torch.as_tensor(k)
    lse = t_fa.flash_attention_lse_plain(q4, kt)
    _, sc, mask = t_fa._scores_plain(q4, kt, 0.0)
    p = torch.where(mask, torch.exp(sc - lse[..., None]), 0.0)
    torch.testing.assert_close(p.sum(-1), torch.ones_like(lse))
    torch.testing.assert_close(lse[..., 0], sc[..., 0, 0])


CAP_CASES = {str(c.dtype)[6:]: c for c in cs.flash_bwd_cases()
             if c.q_scale > 1}   # softcap 5 on scores that reach the cap


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fault", ["none", "no_D", "no_cap_derivative"])
def test_grad_error_limits_separate_planted_faults(dtype, fault):
    """The card's limits pass the equations computed apart (float32: in
    float64; bf16: with the kernel's bf16 rounding of P and dS) and fail
    the same with one fault planted, on every one of dq and dk, at the
    inputs of the card's cases whose scores reach the cap."""
    case = CAP_CASES[dtype]
    q, k, v, do = cs.flash_bwd_inputs(case, "cpu")
    cap = case.softcap
    o = t_fa.flash_attention_bshd_plain(q, k, v, softcap=cap)
    lse = t_fa.flash_attention_lse_plain(q, k, softcap=cap)
    want = t_fa.flash_attention_backward_plain(q, k, v, o, lse, do,
                                               softcap=cap)
    bf16 = dtype == "bfloat16"
    got = cs.flash_backward_ref(q, k, v, o, do, cap, bf16_operands=bf16,
                                fault=fault)
    limit = cs.FLASH_BF16_ROW_TOL if bf16 else cs.FLASH_BWD_F32_TOL
    errs = [t_fa.grad_error(a, w) for a, w in zip(got, want)]
    if fault == "none":
        assert max(errs) <= limit / cs.FAULT_MARGIN, errs
    else:   # dv does not see dS
        assert min(errs[:2]) >= cs.FAULT_MARGIN * limit, errs


def test_float32_limit_passes_a_second_float32_backward():
    """Autograd of the plain forward, a second sound float32 computation
    (D as the sum of P dP, not of dO O), reads within the card's float32
    limit of the plain backward, with the margin the planted-fault test
    asks, at every float32 case of the card small enough for the CPU."""
    for case in cs.flash_bwd_cases():
        if case.dtype != torch.float32:
            continue
        q, k, v, do = cs.flash_bwd_inputs(case, "cpu")
        cap = case.softcap
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
        o = t_fa.flash_attention_bshd_plain(qg, kg, vg, softcap=cap)
        o.backward(do)
        lse = t_fa.flash_attention_lse_plain(q, k, softcap=cap)
        want = t_fa.flash_attention_backward_plain(q, k, v, o.detach(), lse,
                                                   do, softcap=cap)
        errs = [t_fa.grad_error(t.grad, w) for t, w in zip((qg, kg, vg),
                                                           want)]
        assert max(errs) <= cs.FLASH_BWD_F32_TOL / cs.FAULT_MARGIN, \
            (case.name, errs)


@pytest.mark.parametrize("bad", ["lse_shape", "lse_dtype", "o_shape",
                                 "do_dtype"])
def test_backward_refuses_bad_operands(bad):
    q = torch.zeros((1, 8, 4, 64))
    k = v = torch.zeros((1, 8, 2, 64))
    o, do = q.clone(), q.clone()
    lse = torch.zeros((1, 4, 8))
    if bad == "lse_shape":
        lse = torch.zeros((1, 8, 4))
    elif bad == "lse_dtype":
        lse = lse.double()
    elif bad == "o_shape":
        o = torch.zeros((1, 8, 4, 32))
    else:
        do = do.to(torch.bfloat16)
    with pytest.raises(ValueError):
        t_fa.flash_attention_backward(q, k, v, o, lse, do)


def test_backward_registered_with_build_and_counters():
    """The backward's source is built with the others and counted under
    its own name; on the CPU the wrapper runs the plain version, on meta
    the dry run's branch (no launch counted); any other device is
    refused."""
    assert "flash_attn_bwd" in _build.SOURCES
    assert (_build.CSRC / "flash_attn_bwd.cu").exists()
    assert kernels.KERNEL_WRAPPERS["flash_attention_backward"] is \
        t_fa.flash_attention_backward
    kernels.reset_launch_counts()
    q, k = torch.zeros((1, 8, 4, 64)), torch.zeros((1, 8, 2, 64))
    lse = t_fa.flash_attention_lse_plain(q, k)
    out = t_fa.flash_attention_backward(q, k, k, q, lse, q)
    assert all(float(t.abs().max()) == 0 for t in out)
    assert kernels.launch_counts()["flash_attention_backward"] == 0
    meta = torch.empty((1, 8, 4, 64), device="meta")
    kv = torch.empty((1, 8, 2, 64), device="meta")
    got = t_fa.flash_attention_backward(
        meta, kv, kv, meta, torch.empty((1, 4, 8), device="meta"), meta)
    assert [tuple(t.shape) for t in got] == [(1, 8, 4, 64), (1, 8, 2, 64),
                                             (1, 8, 2, 64)]
    assert all(t.is_meta for t in got)
    assert kernels.launch_counts()["flash_attention_backward"] == 0
    q4, kv4 = _elsewhere((1, 8, 4, 64)), _elsewhere((1, 8, 2, 64))
    with pytest.raises(ValueError, match="unsupported device"):
        t_fa.flash_attention_backward(q4, kv4, kv4, q4,
                                      _elsewhere((1, 4, 8)), q4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


CUDA_CASES = [  # (h, hkv, sq, skv, hd, dtype, softcap)
    (8, 4, 512, 512, 64, torch.float32, 0.0),
    (16, 4, 333, 333, 128, torch.float32, 0.0),    # ragged, GQA 4
    (8, 1, 200, 517, 256, torch.float32, 0.0),     # MQA, Sq < Skv
    (24, 8, 1000, 1000, 128, torch.bfloat16, 0.0),  # ragged, llama's G=3
    (8, 8, 256, 256, 64, torch.bfloat16, 30.0),    # grok's softcap
    (8, 1, 1000, 1000, 256, torch.bfloat16, 0.0),  # gemma: MQA, hd 256
    (4, 2, 1, 1, 128, torch.bfloat16, 0.0),        # one query, one key
    (6, 2, 777, 777, 64, torch.bfloat16, 0.0),     # ragged at every tile
    (8, 2, 300, 900, 128, torch.bfloat16, 0.0),    # Sq < Skv
    (4, 4, 130, 333, 256, torch.bfloat16, 0.0),    # Sq < Skv at hd 256
    (8, 8, 777, 777, 112, torch.float32, 0.0),     # zamba2: hd 112
    (32, 32, 1000, 1000, 112, torch.bfloat16, 0.0),  # zamba2: hd 112
    (4, 2, 300, 900, 112, torch.bfloat16, 30.0),   # hd 112, Sq < Skv
]


def _model_layout(device, h, hkv, sq, skv, hd, dtype, fused):
    """q (2, Sq, H, hd) and k, v (2, Skv, Hkv, hd) in the model's layout:
    each its own tensor, or (``fused``, Sq = Skv) views into one
    (2, S, H + 2 Hkv, hd) tensor, whose rows are H + 2 Hkv heads apart."""
    rng = np.random.default_rng(h + sq + skv + hd)
    if fused:
        qkv = torch.as_tensor(rng.normal(size=(2, sq, h + 2 * hkv, hd)),
                              device=device).to(dtype)
        return qkv.split([h, hkv, hkv], dim=2)
    return tuple(torch.as_tensor(rng.normal(size=(2, n, heads, hd)),
                                 device=device).to(dtype)
                 for n, heads in ((sq, h), (skv, hkv), (skv, hkv)))


@pytest.mark.torch_cuda
class TestFlashAttentionOnCuda:
    """The Hopper kernel equals its plain version on the card."""

    @pytest.mark.parametrize("h,hkv,sq,skv,hd,dtype,softcap", CUDA_CASES)
    def test_kernel_matches_plain(self, cuda_device, h, hkv, sq, skv, hd,
                                  dtype, softcap):
        q, k, v = (torch.as_tensor(a, device=cuda_device).to(dtype)
                   for a in _qkv(h + sq + hd, h, hkv, sq, skv, hd))
        launches = kernels.launched(t_fa.flash_attention)
        got = t_fa.flash_attention(q, k, v, group=h // hkv, softcap=softcap)
        torch.cuda.synchronize()
        assert kernels.launched(t_fa.flash_attention) == launches + 1
        want = t_fa.flash_attention_plain(q, k, v, group=h // hkv,
                                          softcap=softcap)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
        else:
            assert got.dtype == dtype
            assert t_fa.row_error(got, want) <= BF16_ROW_TOL

    @pytest.mark.parametrize("fused", [False, True])
    @pytest.mark.parametrize("h,hkv,sq,skv,hd,dtype,softcap", CUDA_CASES)
    def test_model_layout_kernel_matches_plain(self, cuda_device, h, hkv, sq,
                                               skv, hd, dtype, softcap,
                                               fused):
        """`flash_attention_bshd` reads the model's (B, S, H, hd) operands
        where they lie, views into a fused qkv tensor too."""
        if fused and sq != skv:
            pytest.skip("a fused qkv tensor has one length")
        q, k, v = _model_layout(cuda_device, h, hkv, sq, skv, hd, dtype,
                                fused)
        launches = kernels.launched(t_fa.flash_attention)
        got = t_fa.flash_attention_bshd(q, k, v, softcap=softcap)
        torch.cuda.synchronize()
        assert kernels.launched(t_fa.flash_attention) == launches + 1
        assert got.shape == q.shape and got.is_contiguous()
        want = t_fa.flash_attention_bshd_plain(q, k, v, softcap=softcap)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
        else:
            assert got.dtype == dtype
            assert t_fa.row_error(got, want) <= BF16_ROW_TOL

    def test_kernel_is_deterministic(self, cuda_device):
        q, k, v = (torch.as_tensor(a, device=cuda_device).to(torch.bfloat16)
                   for a in _qkv(3, 24, 8, 700, 700, 128))
        one = t_fa.flash_attention(q, k, v, group=3)
        assert torch.equal(one, t_fa.flash_attention(q, k, v, group=3))

    @pytest.mark.parametrize("hd", t_fa.HEAD_DIMS)
    def test_tensor_core_kernel_is_deterministic(self, cuda_device, hd):
        q, k, v = _model_layout(cuda_device, 8, 2, 1000, 1000, hd,
                                torch.bfloat16, fused=True)
        one = t_fa.flash_attention_bshd(q, k, v)
        for _ in range(3):
            assert torch.equal(one, t_fa.flash_attention_bshd(q, k, v))

    def test_prefill_attention_launches_no_copies(self, cuda_device):
        """The model's prefill attention at llama3.2-3b's layout runs the
        attention kernel and nothing else on the card: no permute or copy
        of q, k, v or the output around it."""
        b, s, kv, g, hd = 2, 512, 8, 3, 128
        qkv = torch.randn((b, s, kv * (g + 2), hd), device=cuda_device,
                          dtype=torch.bfloat16)
        q, k, v = qkv.split([kv * g, kv, kv], dim=2)
        k, v = k.contiguous(), v.contiguous()
        qg = q.contiguous().reshape(b, s, kv, g, hd)
        t_attn.chunked_prefill_attention(qg, k, v)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            out = t_attn.chunked_prefill_attention(qg, k, v)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert names and all("flash_attn" in n for n in names), names
        assert out.shape == qg.shape
        # the attention block's reshape of the output is a view
        assert out.reshape(b, s, kv * g * hd).data_ptr() == out.data_ptr()

    def test_unsupported_head_dim_raises(self, cuda_device):
        q = torch.zeros((2, 8, 96), device=cuda_device)
        with pytest.raises(ValueError, match="head dim"):
            t_fa.flash_attention(q, q, q)


@pytest.mark.torch_cuda
class TestFlashBackwardOnCuda:
    """The backward kernels equal their plain version on the card, give the
    same bits twice, and are what autograd runs through the wrappers."""

    @pytest.mark.parametrize("case", cs.flash_bwd_cases(),
                             ids=lambda c: c.name.replace(" ", "_"))
    def test_backward_matches_plain(self, cuda_device, case):
        """`chip_smoke.check_flash_backward`: the log-sum-exp, dq, dk and
        dv within their limits, two calls bit-equal, autograd through both
        wrappers == the kernel, planted faults read where the cap is
        reached."""
        launches = kernels.launched(t_fa.flash_attention_backward)
        res = cs.check_flash_backward(case)
        assert len(res["errs"]) == 3
        assert kernels.launched(t_fa.flash_attention_backward) > launches + 1

    def test_autograd_runs_the_kernels(self, cuda_device):
        q, k, v = _model_layout(cuda_device, 8, 2, 300, 300, 128,
                                torch.bfloat16, fused=False)
        do = torch.randn_like(q)
        o, lse = t_fa.flash_attention_forward(q, k, v)
        want = t_fa.flash_attention_backward(q, k, v, o, lse, do)
        fwd = kernels.launched(t_fa.flash_attention)
        bwd = kernels.launched(t_fa.flash_attention_backward)
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
        t_fa.flash_attention_bshd(qg, kg, vg).backward(do)
        assert kernels.launched(t_fa.flash_attention) == fwd + 1
        assert kernels.launched(t_fa.flash_attention_backward) == bwd + 1
        for t, w in zip((qg, kg, vg), want):
            assert torch.equal(t.grad, w)
