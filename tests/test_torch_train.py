"""The port's LM training loss held to the JAX package on the CPU: the data
pipeline's tokens, `chunked_ce_loss`, `lm_loss` and their gradients on the
float32 reduced configs of llama3.2-3b, grok-1-314b, mamba2-1.3b,
zamba2-7b and paligemma-3b (with its prefix), on the JAX package's own
parameters (the port's random ones, the same numbers on both sides:
`shared_params`); and a falling loss on a fixed batch.

Tolerances (float32 throughout):
- tokens: equal.
- losses: within 1e-5. The sides sum in other orders (XLA's einsums and
  chunked online softmax against PyTorch's matmuls and the plain
  attention) and take their own `exp`, `log` and `rsqrt`.
- gradients: each leaf within 1e-4 of its largest magnitude in the JAX
  gradient. The MoE's router picks are discrete, so both sides pick alike
  on these inputs or the test would not hold at all; the SSM and hybrid
  models at 2^-8 of that scale: the SSD rounds its weight block to bf16
  in every dtype (ROADMAP Queue 3), so an input differing in the
  last bit rounds to another bf16 value now and then, and the gradient
  passes through that rounding too (`tests/test_torch_ssm.py`'s limit).

The JAX package is imported by a fixture, so the machine with the card
(which has no JAX) skips the parity tests.
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from repro_torch import convert, pytree
from repro_torch.configs import get_config, reduced_config
from repro_torch.data import SyntheticLMData
from repro_torch.models import lm, transformer

ARCHS = ["llama3.2-3b", "grok-1-314b", "mamba2-1.3b", "zamba2-7b",
         "paligemma-3b"]
SSM_LIKE = ("mamba2-1.3b", "zamba2-7b")
B, S = 2, 64
LOSS_TOL = 1e-5


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
    from repro import configs
    from repro.data import pipeline as j_data
    from repro.models import lm as j_lm
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, configs=configs,
                                 lm=j_lm, data=j_data)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (B, S - cfg.prefix_len)).astype(np.int32)}
    if cfg.prefix_len:
        out["prefix_embed"] = rng.normal(
            size=(B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return out


def shared_params(jx, cfg, seed):
    """(numpy tree, the JAX package's tree of it): the port's random
    parameters (`transformer.init_params` on the CPU), the same numbers on
    both sides; the trees are the same, leaf for leaf."""
    params_np = pytree.tree_map(lambda t: t.numpy(),
                                transformer.init_params(seed, cfg,
                                                        device="cpu"))
    return params_np, pytree.tree_map(jx.jnp.asarray, params_np)


def _grads_t(params, fn):
    """(value, grads tree) of ``fn(params)`` by autograd on every leaf."""
    paths = pytree.leaves_with_paths(params)
    leaves = [t.requires_grad_(True) for _, t in paths]
    value = fn(params)
    gs = torch.autograd.grad(value, leaves, allow_unused=True)
    grads = {}
    for (path, t), g in zip(paths, gs):
        grads[pytree.path_str(path)] = torch.zeros_like(t) if g is None else g
    for t in leaves:
        t.requires_grad_(False)
    return float(value.detach()), grads


def _hold_grads(got: dict, want_tree, rel: float):
    want = {pytree.path_str(p): np.asarray(w)
            for p, w in pytree.leaves_with_paths(want_tree)}
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key].detach().numpy()
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= rel * max(scale, 1e-30), (key, err, scale)


@pytest.mark.parametrize("step,shard,n_shards", [(0, 0, 1), (3, 1, 2),
                                                 (17, 3, 4)])
def test_data_tokens_equal_jax(jx, step, shard, n_shards):
    for vocab, seq, batch, seed in ((256, 33, 8, 0), (4096, 128, 4, 7)):
        want = jx.data.SyntheticLMData(vocab, seq, batch, seed=seed).batch(
            step, shard, n_shards)["tokens"]
        got = SyntheticLMData(vocab, seq, batch, seed=seed).batch(
            step, shard, n_shards)["tokens"]
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_metrics_and_grads_match_jax(jx, arch):
    """The loss, its metrics and every parameter's gradient of `lm_loss`
    (remat on, the config's CE chunks, the MoE aux loss, the vlm
    prefix)."""
    cfg_j = jx.configs.reduced_config(jx.configs.get_config(arch))
    cfg_t = reduced_config(get_config(arch))
    params_np, params_j = shared_params(jx, cfg_t, len(arch))
    batch = _batch(cfg_t, len(arch))
    jb = {k: jx.jnp.asarray(v) for k, v in batch.items()}
    (want, want_m), want_g = jx.jax.value_and_grad(
        lambda p: jx.lm.lm_loss(p, cfg_j, jb), has_aux=True)(params_j)
    params_t = convert.lm_params_from_arrays(params_np, cfg_t, device="cpu")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    metrics = {}

    def loss_t(p):
        loss, m = lm.lm_loss(p, cfg_t, tb)
        metrics.update(m)
        return loss

    got, got_g = _grads_t(params_t, loss_t)
    assert abs(got - float(want)) <= LOSS_TOL, (got, float(want))
    assert set(metrics) == set(want_m) == {"ce_loss", "aux_loss", "tokens"}
    for key in metrics:
        assert abs(float(metrics[key]) - float(want_m[key])) <= LOSS_TOL, key
    assert float(metrics["tokens"]) == B * (S - cfg_t.prefix_len - 1)
    _hold_grads(got_g, want_g, 2.0 ** -8 if arch in SSM_LIKE else 1e-4)


@pytest.mark.parametrize("s,chunk", [(64, 64), (96, 64), (40, 16)])
def test_chunked_ce_loss_matches_jax(jx, s, chunk):
    """Chunks of `loss_chunk`, halved until they divide S (96 -> 32, 40 ->
    8), a partial mask; the loss, the token count and the gradients of the
    hidden states and the (untied) head."""
    arch = "grok-1-314b"
    cfg_j = jx.configs.reduced_config(jx.configs.get_config(arch),
                                      loss_chunk=chunk)
    cfg_t = reduced_config(get_config(arch), loss_chunk=chunk)
    rng = np.random.default_rng(s)
    hidden = rng.normal(size=(B, s, cfg_t.d_model)).astype(np.float32)
    head = (rng.normal(size=(cfg_t.padded_vocab, cfg_t.d_model)) * 0.1
            ).astype(np.float32)
    targets = rng.integers(0, cfg_t.vocab_size, (B, s)).astype(np.int32)
    mask = (rng.random((B, s)) < 0.8).astype(np.int32)

    def f_j(h, w):
        return jx.lm.chunked_ce_loss({"lm_head": w}, cfg_j, h,
                                     jx.jnp.asarray(targets),
                                     jx.jnp.asarray(mask))

    (want, want_cnt), want_g = jx.jax.value_and_grad(
        f_j, argnums=(0, 1), has_aux=True)(jx.jnp.asarray(hidden),
                                           jx.jnp.asarray(head))
    h_t = torch.as_tensor(hidden).requires_grad_(True)
    w_t = torch.as_tensor(head).requires_grad_(True)
    got, cnt = lm.chunked_ce_loss({"lm_head": w_t}, cfg_t, h_t,
                                  torch.as_tensor(targets),
                                  torch.as_tensor(mask))
    got.backward()
    assert abs(float(got) - float(want)) <= LOSS_TOL
    assert float(cnt) == float(want_cnt) == float(mask.sum())
    for g, w in zip((h_t.grad, w_t.grad), want_g):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_loss_falls_on_a_fixed_batch():
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import adamw
    from repro_torch.runtime import train

    cfg = reduced_config(get_config("llama3.2-3b"))
    state, _ = launch_train.build(cfg, steps=10, device="cpu")
    step_fn = train.make_train_step(cfg, optimizer=adamw(lr=3e-3))
    state.opt_state = adamw(lr=3e-3).init(state.params)
    batch = {"tokens": torch.as_tensor(
        SyntheticLMData(cfg.vocab_size, 64, 4, seed=1).batch(0)["tokens"])}
    losses = []
    for _ in range(6):
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    assert int(state.step) == 6
