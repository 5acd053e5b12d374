"""The port's LM serving path (`repro_torch.models`, `runtime/lm_serve.py`)
held to the JAX package on the CPU, for every `attn_mlp` architecture at
its reduced float32 config (2 layers, d_model 64, 4 query heads, 16-wide
heads), on the JAX package's own parameters carried across with
`convert.lm_params_from_arrays`.

Tolerances (float32 throughout):
- hidden states, prefill and decode logits, and caches: rtol = atol =
  1e-5. Both sides compute the same float32 functions with different
  summation orders: XLA's einsums against PyTorch's matmuls, the JAX
  package's chunked online softmax against the port's full softmax (the
  plain version of `flash_attention` on the CPU), and their own `rsqrt`,
  `tanh` and `exp`. The largest difference measured is 4.3e-6, on hidden
  states up to 3.7 in magnitude.
- greedy `generate` tokens: equal. The logits agree to 4.1e-6, far inside
  the smallest gap between a row's two largest logits (0.019).

The JAX package is imported by a fixture, so the machine with the card
(which has no JAX) skips the parity tests.
"""
from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import CudaUnavailableError, convert
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.models import lm, transformer
from repro_torch.runtime import lm_serve

TOL = 1e-5
ATTN_MLP_ARCHS = ["llama3.2-3b", "gemma-2b", "minitron-8b", "command-r-35b",
                  "musicgen-large", "paligemma-3b"]
B, S, S_MAX, N_TOKENS = 2, 32, 48, 6


@pytest.fixture(scope="module")
def jax_mods():
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.models import lm as j_lm
    from repro.models import transformer as j_tf
    from repro.runtime import lm_serve as j_serve
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, configs=configs,
                                 lm=j_lm, tf=j_tf, serve=j_serve)


@pytest.fixture(scope="module", params=ATTN_MLP_ARCHS)
def pair(request, jax_mods):
    """One architecture on both sides: configs, the JAX parameters and the
    port's copy of them, and a numpy prompt batch."""
    arch = request.param
    j = jax_mods
    cfg_j = j.configs.reduced_config(j.configs.get_config(arch))
    cfg_t = reduced_config(get_config(arch))
    params_j = j.tf.init_params(j.jax.random.PRNGKey(0), cfg_j)
    params_np = j.jax.tree.map(np.asarray, params_j)
    params_t = convert.lm_params_from_arrays(params_np, cfg_t, device="cpu")
    rng = np.random.default_rng(len(arch))
    shape = (B, S - cfg_t.prefix_len)
    batch = {"tokens": rng.integers(0, cfg_t.vocab_size, shape).astype(
        np.int32)}
    if cfg_t.prefix_len:
        batch["prefix_embed"] = rng.normal(
            size=(B, cfg_t.prefix_len, cfg_t.d_model)).astype(np.float32)
    return types.SimpleNamespace(
        arch=arch, cfg_j=cfg_j, cfg_t=cfg_t, params_j=params_j,
        params_t=params_t, batch=batch)


def _jbatch(j, batch):
    return {k: j.jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_forward_hidden_matches_jax(jax_mods, pair):
    jb, tb = _jbatch(jax_mods, pair.batch), _tbatch(pair.batch)
    want, _, _ = jax_mods.tf.forward(pair.params_j, pair.cfg_j, jb["tokens"],
                                     prefix_embed=jb.get("prefix_embed"))
    got, _, aux = transformer.forward(pair.params_t, pair.cfg_t,
                                      tb["tokens"],
                                      prefix_embed=tb.get("prefix_embed"))
    assert got.shape == (B, S, pair.cfg_t.d_model)
    assert aux.dtype == torch.float32 and float(aux) == 0.0
    _close(got, want)


def test_prefill_logits_and_caches_match_jax(jax_mods, pair):
    want_logits, want_caches = jax_mods.lm.prefill(
        pair.params_j, pair.cfg_j, _jbatch(jax_mods, pair.batch))
    got_logits, got_caches = lm.prefill(pair.params_t, pair.cfg_t,
                                        _tbatch(pair.batch))
    assert got_logits.shape == (B, 1, pair.cfg_t.padded_vocab)
    _close(got_logits, want_logits)
    for got, want in zip(got_caches["kv"], want_caches["kv"]):
        assert got.shape == (pair.cfg_t.n_layers, B, S, pair.cfg_t.n_kv_heads,
                             pair.cfg_t.head_dim)
        _close(got, want)


def test_prefill_into_decode_slots_matches_jax(jax_mods, pair):
    """Prefill with s_max writes the prompt's k and v straight into the
    decode layout: the JAX package's prefill and `extend_caches`, and the
    port's own exact-length caches extended, to the bit."""
    j = jax_mods
    want_logits, jc = j.lm.prefill(pair.params_j, pair.cfg_j,
                                   _jbatch(j, pair.batch))
    jc = j.lm.extend_caches(pair.cfg_j, jc, S_MAX)
    got_logits, tc = lm.prefill(pair.params_t, pair.cfg_t,
                                _tbatch(pair.batch), s_max=S_MAX)
    exact_logits, ec = lm.prefill(pair.params_t, pair.cfg_t,
                                  _tbatch(pair.batch))
    ec = lm.extend_caches(pair.cfg_t, ec, S_MAX)
    _close(got_logits, want_logits)
    assert torch.equal(got_logits, exact_logits)
    for got, want, ext in zip(tc["kv"], jc["kv"], ec["kv"]):
        assert got.shape == (pair.cfg_t.n_layers, B, S_MAX,
                             pair.cfg_t.n_kv_heads, pair.cfg_t.head_dim)
        _close(got, want)
        assert torch.equal(got, ext)
    with pytest.raises(ValueError, match="s_max"):
        lm.prefill(pair.params_t, pair.cfg_t, _tbatch(pair.batch),
                   s_max=S - 1)


def test_decode_step_matches_jax(jax_mods, pair):
    """One decode step at position S after a prefill, on both sides: the
    logits and the cache written in place at S."""
    j = jax_mods
    _, jc = j.lm.prefill(pair.params_j, pair.cfg_j, _jbatch(j, pair.batch))
    jc = j.lm.extend_caches(pair.cfg_j, jc, S_MAX)
    token = np.arange(B, dtype=np.int32)[:, None] + 7
    want, jc = j.lm.decode_step(pair.params_j, pair.cfg_j,
                                j.jnp.asarray(token), jc, j.jnp.int32(S))
    _, tc = lm.prefill(pair.params_t, pair.cfg_t, _tbatch(pair.batch))
    tc = lm.extend_caches(pair.cfg_t, tc, S_MAX)
    got, tc2 = lm.decode_step(pair.params_t, pair.cfg_t,
                              torch.as_tensor(token), tc, S)
    assert tc2["kv"][0] is tc["kv"][0]          # written in place
    _close(got, want)
    for got_c, want_c in zip(tc2["kv"], jc["kv"]):
        assert got_c.shape[2] == S_MAX
        _close(got_c, want_c)


def test_greedy_generate_matches_jax(jax_mods, pair):
    want = jax_mods.serve.generate(pair.params_j, pair.cfg_j,
                                   _jbatch(jax_mods, pair.batch),
                                   n_tokens=N_TOKENS, s_max=S_MAX)
    got = lm_serve.generate(pair.params_t, pair.cfg_t, _tbatch(pair.batch),
                            n_tokens=N_TOKENS, s_max=S_MAX)
    assert got.dtype == torch.int32 and got.shape == (B, N_TOKENS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_jax(jax_mods, arch):
    """The port's configs are copies: every field equal, full and reduced."""
    for port, ref in ((get_config(arch), jax_mods.configs.get_config(arch)),
                      (reduced_config(get_config(arch)),
                       jax_mods.configs.reduced_config(
                           jax_mods.configs.get_config(arch)))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.n_params_dense_estimate == ref.n_params_dense_estimate


def test_decode_matches_fresh_prefill():
    """The port against itself (as `tests/test_archs.py` holds the JAX
    package): decoding the last token after a prefill of the others gives
    the last-position logits of a forward over all of them."""
    cfg = reduced_config(get_config("llama3.2-3b"))
    params = transformer.init_params(0, cfg, device="cpu")
    tok = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, 24)))
    hidden, _, _ = transformer.forward(params, cfg, tok)
    full = transformer.logits_from_hidden(params, cfg, hidden[:, -1:])
    _, caches = lm.prefill(params, cfg, {"tokens": tok[:, :-1]})
    caches = lm.extend_caches(cfg, caches, 28)
    got, _ = lm.decode_step(params, cfg, tok[:, -1:], caches, 23)
    torch.testing.assert_close(got, full, rtol=TOL, atol=TOL)


def test_sampling_follows_the_generator():
    cfg = reduced_config(get_config("gemma-2b"))
    params = transformer.init_params(3, cfg, device="cpu")
    batch = {"tokens": torch.arange(2 * 16, dtype=torch.int32).reshape(2, 16)}

    def sample(seed):
        gen = torch.Generator().manual_seed(seed)
        return lm_serve.generate(params, cfg, batch, n_tokens=8, s_max=24,
                                 greedy=False, generator=gen)

    assert torch.equal(sample(5), sample(5))
    assert int(sample(5).max()) < cfg.vocab_size
    with pytest.raises(ValueError, match="Generator"):
        lm_serve.generate(params, cfg, batch, n_tokens=2, s_max=24,
                          greedy=False)
    assert lm_serve.generate(params, cfg, batch, n_tokens=0,
                             s_max=24).shape == (2, 0)


def test_entry_points_default_to_cuda():
    """Without a card the entry points raise for an attention + MLP config
    and a MoE one alike; they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    for arch in ("llama3.2-3b", "kimi-k2-1t-a32b"):
        cfg = reduced_config(get_config(arch))
        with pytest.raises(CudaUnavailableError):
            transformer.init_params(0, cfg)
        with pytest.raises(CudaUnavailableError):
            lm.init_caches(cfg, 1, 8)
        params = transformer.init_params(0, cfg, device="cpu")
        with pytest.raises(CudaUnavailableError):
            convert.lm_params_from_arrays(params, cfg)


def test_caches_and_extend():
    cfg = reduced_config(get_config("musicgen-large"))
    caches = lm.init_caches(cfg, 3, 10, device="cpu")
    for t in caches["kv"]:
        assert t.shape == (2, 3, 10, 2, 16) and not t.any()
    k = torch.ones((2, 3, 4, 2, 16))
    ext = lm.extend_caches(cfg, {"kv": (k, k)}, 10)
    assert ext["kv"][0].shape == (2, 3, 10, 2, 16)
    assert bool(ext["kv"][0][:, :, :4].eq(1).all())
    assert not ext["kv"][0][:, :, 4:].any()
    with pytest.raises(ValueError, match="s_max"):
        lm.extend_caches(cfg, {"kv": (k, k)}, 3)
