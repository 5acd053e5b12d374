"""The port's optimizers (`repro_torch.optim`) and the int8 gradient codes
held to the JAX package's (`repro.optim`) on the CPU, on trees of float32
leaves of 1, 2 and 3 dims made from a seed with numpy.

Tolerances: 2 float32 ulps of the JAX value, element by element, for
`adamw` and `adafactor` over three updates (params and state after each;
a parameter's ulps are those of the larger of its new and old value, since
p - lr * upd can cancel to a number whose last bits are p's),
`clip_by_global_norm` (the norm and every clipped leaf, clipping active and
not) and `warmup_cosine_schedule`. Both sides compute each element with
the same float32 operations in the same order; what differs is the
implementation of `pow`, `cos`, `sqrt` and `rsqrt` (ATen against XLA; an
ulp at most, ROADMAP Queue 3) and the summation order of a reduction
(`mean`, a leaf's sum of squares) over up to 60 elements. bfloat16
parameters are held to one bf16 ulp. The int8 codes are equal, element for
element.

The JAX package is imported by a fixture, so the machine with the card
(which has no JAX) skips these tests.
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from repro_torch import optim
from repro_torch.optim import compress

SHAPES = {"a": (7,), "b": {"w": (5, 6), "z": (3, 4, 5)}, "c": (2, 3)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module, restored after it: at these
    sizes PyTorch's threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.optim import compress as j_compress
    from repro.optim import optimizers as j_opt
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, opt=j_opt,
                                 compress=j_compress)


def _tree(rng, scale=1.0, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(rng, scale, v) for k, v in shapes.items()}
    return (rng.normal(size=shapes) * scale).astype(np.float32)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _pairs(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def assert_ulps(got, want, n=2, before=None):
    """Every element of ``got`` within ``n`` float32 ulps of ``want``'s; with
    ``before`` (the tree the update started from), ulps of the larger of
    the result and the value it was computed from: p - lr * upd can cancel
    to a number far smaller than either, whose last bits are those of p."""
    before = {p: b for p, b, _ in _pairs(before, before)} \
        if before is not None else {}
    for path, g, w in _pairs(got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, path
        mag = np.abs(w)
        if path in before:
            mag = np.maximum(mag, np.abs(_np(before[path])))
        tol = n * np.spacing(mag.astype(np.float32))
        bad = np.abs(g - w) > tol
        assert not bad.any(), (path, np.abs(g - w).max(), tol[bad].max())


def _torch(tree, dtype=torch.float32):
    return _map(lambda a: torch.as_tensor(np.array(a)).to(dtype), tree)


@pytest.mark.parametrize("steps", [(0, 1, 2), (11, 12, 30)])
def test_schedule_matches_jax(jx, steps):
    sched_j = jx.opt.warmup_cosine_schedule(3e-3, 10, 25)
    sched_t = optim.warmup_cosine_schedule(3e-3, 10, 25)
    for step in (*steps, 10, 24, 25):
        want = np.asarray(sched_j(jx.jnp.int32(step)))
        got = sched_t(torch.tensor(step, dtype=torch.int32))
        assert_ulps(got, want)


@pytest.mark.parametrize("max_norm", [1e3, 0.5])
def test_clip_by_global_norm_matches_jax(jx, max_norm):
    g = _tree(np.random.default_rng(1), 0.3)
    want, want_norm = jx.opt.clip_by_global_norm(
        _map(jx.jnp.asarray, g), max_norm)
    got, got_norm = optim.clip_by_global_norm(_torch(g), max_norm)
    assert_ulps(got_norm, np.asarray(want_norm))
    assert_ulps(got, _map(np.asarray, want))
    if max_norm < 1:
        assert float(got_norm) > max_norm   # the clip is active


def _run(jx, name, kw, n_steps=3, dtype=torch.float32, cos=False):
    """``n_steps`` updates of both optimizers from the same params (with
    ``cos``, on each package's warmup-cosine schedule); yields (port
    params, port state, JAX params, JAX state) after each."""
    rng = np.random.default_rng(7)
    params = _tree(rng)
    sched = {}
    if cos:
        sched = {"j": dict(schedule=jx.opt.warmup_cosine_schedule(1e-2, 1,
                                                                  3)),
                 "t": dict(schedule=optim.warmup_cosine_schedule(1e-2, 1,
                                                                 3))}
    opt_j = getattr(jx.opt, name)(**kw, **sched.get("j", {}))
    opt_t = getattr(optim, name)(**kw, **sched.get("t", {}))
    jdt = jx.jnp.bfloat16 if dtype == torch.bfloat16 else jx.jnp.float32
    p_j = _map(lambda a: jx.jnp.asarray(a, jdt), params)
    p_t = _torch(params, dtype)
    s_j, s_t = opt_j.init(p_j), opt_t.init(p_t)
    for step in range(n_steps):
        g = _tree(rng, 0.1 * (step + 1))
        prev = _map(np.asarray, p_j)
        p_j, s_j = opt_j.update(_map(jx.jnp.asarray, g), s_j, p_j,
                                jx.jnp.int32(step))
        got = opt_t.update(_torch(g), s_t, p_t,
                           torch.tensor(step, dtype=torch.int32))
        assert got[0] is p_t and got[1] is s_t   # updated in place
        yield p_t, s_t, p_j, s_j, prev


@pytest.mark.parametrize("cos", [False, True])
def test_adamw_matches_jax(jx, cos):
    for p_t, s_t, p_j, s_j, prev in _run(jx, "adamw",
                                         dict(lr=1e-2, weight_decay=0.05),
                                         cos=cos):
        assert_ulps(p_t, _map(np.asarray, p_j), before=prev)
        assert_ulps(s_t, _map(np.asarray, s_j))


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adafactor_matches_jax(jx, weight_decay):
    for p_t, s_t, p_j, s_j, prev in _run(
            jx, "adafactor", dict(lr=1e-2, weight_decay=weight_decay),
            cos=weight_decay > 0):
        assert_ulps(p_t, _map(np.asarray, p_j), before=prev)
        assert_ulps(s_t, _map(np.asarray, s_j))


def test_bf16_params_within_one_bf16_ulp(jx):
    for name in ("adamw", "adafactor"):
        for p_t, _, p_j, _, _ in _run(jx, name, {}, n_steps=2,
                                      dtype=torch.bfloat16):
            for path, g, w in _pairs(p_t, p_j):
                g = g.to(torch.float32).numpy()
                w = np.asarray(w.astype(jx.jnp.float32))
                ulp = 2.0 ** (np.floor(np.log2(np.abs(w) + 1e-30)) - 7)
                assert (np.abs(g - w) <= ulp).all(), (name, path)


def test_update_consumes_grads_and_get_optimizer():
    cfg = types.SimpleNamespace(optimizer="adafactor")
    assert optim.get_optimizer(cfg).name == "adafactor"
    cfg.optimizer = "adamw"
    assert optim.get_optimizer(cfg).name == "adamw"
    opt = optim.adamw()
    params = _torch(_tree(np.random.default_rng(3)))
    grads = _torch(_tree(np.random.default_rng(4)))
    opt.update(grads, opt.init(params), params, torch.tensor(0))
    assert grads["a"] is None and grads["b"]["w"] is None


@pytest.mark.parametrize("scale", [1e-3, 1.0, 0.0])
def test_int8_codes_match_jax(jx, scale):
    g = (np.random.default_rng(5).normal(size=(33, 17)) * scale).astype(
        np.float32)
    q_j, s_j = jx.compress.quantize_int8(jx.jnp.asarray(g))
    q_t, s_t = compress.quantize_int8(torch.as_tensor(g))
    assert q_t.dtype == torch.int8
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    assert float(s_t) == float(s_j)
    np.testing.assert_array_equal(
        compress.dequantize_int8(q_t, s_t).numpy(),
        np.asarray(jx.compress.dequantize_int8(q_j, s_j)))
