"""The port's SSM and hybrid LM path (`repro_torch.models.ssm`, the `ssm`
kind of `models/transformer.py`, the SSM caches of `models/lm.py`,
`runtime/lm_serve.py`) held to the JAX package on the CPU: the gated norm,
the causal conv, `ssd_chunked` over several chunks and on a prompt shorter
than the conv window, `ssm_block` prefill and decode, and `forward`,
`prefill`, `extend_caches`, `decode_step` and greedy `generate` for
mamba2-1.3b and zamba2-7b at their reduced float32 configs (2 and 6
layers, d_model 64, SSM state 16, 16-wide SSD heads, chunk 256), plus a
hybrid with a tail (7 layers, shared attention every 3: two super-blocks
and one plain mamba2 layer), on the JAX package's own parameters carried
across with `convert.lm_params_from_arrays`.

Tolerances. The pieces (norm, conv, `ssd_chunked`, `ssm_block`): rtol =
atol = 1e-5, as `tests/test_torch_lm.py` (largest difference measured
2.1e-6): both sides compute the same float32 functions in other summation
orders (XLA's einsums, cumsum and exp against PyTorch's). The models
(hidden states, logits, caches): rtol = atol = 2^-8, one bf16 ulp of an
O(1) value. `ssd_chunked` rounds its (B, Q, Q, NH) weight block and the
chunk's inputs to bfloat16 in every model dtype, as the JAX package does,
so a weight whose two float32 values straddle a bf16 rounding boundary
differs by one bf16 ulp, and the layers after it carry that on: the
largest difference measured is 1.1e-3 (zamba2 with a tail), and the JAX
package's own compiled scan differs from its op-by-op run (under
`jax.disable_jit`) by up to 3.9e-4 for the same reason. The bf16 rounding
itself is held exactly by `test_ssd_rounds_its_weight_block_to_bf16`.
Greedy tokens: equal.

The JAX package is imported by a fixture, so the machine with the card
(which has no JAX) skips the parity tests.
"""
from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import common, lm, ssm, transformer
from repro_torch.runtime import lm_serve

TOL = 1e-5
MODEL_TOL = 2.0 ** -8
B, S, S_MAX, N_TOKENS = 2, 32, 48, 6
# (name, arch, overrides of reduced_config): the two SSM configurations and
# a hybrid whose 7 layers leave a tail of one plain mamba2 layer
MODELS = [("mamba2-1.3b", "mamba2-1.3b", {}),
          ("zamba2-7b", "zamba2-7b", {}),
          ("zamba2-tail", "zamba2-7b",
           {"n_layers": 7, "shared_attn_every": 3})]


@pytest.fixture(scope="module")
def jax_mods():
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.models import common as j_common
    from repro.models import lm as j_lm
    from repro.models import ssm as j_ssm
    from repro.models import transformer as j_tf
    from repro.runtime import lm_serve as j_serve
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, configs=configs,
                                 common=j_common, lm=j_lm, ssm=j_ssm,
                                 tf=j_tf, serve=j_serve)


def _np_tree(j, tree):
    return j.jax.tree.map(np.asarray, tree)


def _t_tree(tree):
    if isinstance(tree, dict):
        return {k: _t_tree(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree))


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def _close_tree(got, want) -> None:
    """A cache tree against the JAX package's at the model tolerance: the
    same keys, shapes and dtypes."""
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            _close_tree(got[k], want[k])
    elif isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close_tree(g, w)
    else:
        assert tuple(got.shape) == tuple(np.shape(want))
        assert str(got.dtype)[6:] == str(np.asarray(want).dtype)
        _close(got, want, MODEL_TOL)


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

def test_norm_like_matches_jax(jax_mods):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3
    w = rng.normal(size=(48,)).astype(np.float32)
    want = jax_mods.common.norm_like({}, jax_mods.jnp.asarray(w),
                                     jax_mods.jnp.asarray(x), "rms")
    got = common.norm_like({}, torch.as_tensor(w), torch.as_tensor(x), "rms")
    _close(got, want)


def test_causal_conv_matches_jax(jax_mods):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32) * 0.2
    b = rng.normal(size=(12,)).astype(np.float32)
    want = jax_mods.ssm._causal_depthwise_conv(
        *(jax_mods.jnp.asarray(a) for a in (x, w, b)))
    got = ssm._causal_depthwise_conv(*(torch.as_tensor(a) for a in (x, w, b)))
    _close(got, want)


def _ssd_inputs(seed, s, nh=3, hd=4, n=5):
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(B, s, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, s, nh)))).astype(np.float32)
    a = -np.exp(rng.normal(size=(nh,)) * 0.5).astype(np.float32)
    b_, c_ = (rng.normal(size=(B, s, n)).astype(np.float32) for _ in "bc")
    d_skip = rng.normal(size=(nh,)).astype(np.float32)
    return xh, dt, a, b_, c_, d_skip


@pytest.mark.parametrize("s,chunk", [(32, 8), (24, 256), (2, 256)],
                         ids=["four-chunks", "one-chunk", "short"])
def test_ssd_chunked_matches_jax(jax_mods, s, chunk):
    """Four chunks of 8 carrying the state, one chunk shorter than the
    default, and a 2-position prompt (shorter than ssm_conv - 1)."""
    args = _ssd_inputs(s, s)
    want_y, want_state = jax_mods.ssm.ssd_chunked(
        *(jax_mods.jnp.asarray(a) for a in args), chunk)
    got_y, got_state = ssm.ssd_chunked(*(torch.as_tensor(a) for a in args),
                                       chunk)
    assert got_y.shape == (B, s, 3, 4) and got_state.shape == (B, 3, 4, 5)
    _close(got_y, want_y)
    _close(got_state, want_state)


def test_ssd_chunked_refuses_a_ragged_prompt(jax_mods):
    """A prompt longer than the chunk must be a multiple of it: the JAX
    package's reshape fails, and the port says why (nothing is padded)."""
    args = _ssd_inputs(3, 20)
    with pytest.raises(TypeError):
        jax_mods.ssm.ssd_chunked(*(jax_mods.jnp.asarray(a) for a in args), 8)
    with pytest.raises(ValueError, match="multiple of the SSD chunk 8"):
        ssm.ssd_chunked(*(torch.as_tensor(a) for a in args), 8)


def test_ssd_rounds_its_weight_block_to_bf16():
    """The intra-chunk product takes the weight block and x rounded to
    bfloat16 (then float32 accumulation) in a float32 model too: with one
    key (S=1), y = bf16(C.B * dt) * bf16(x) + D x exactly."""
    xh, dt, a, b_, c_, d_skip = (torch.as_tensor(t) for t in
                                 _ssd_inputs(4, 1))
    y, _ = ssm.ssd_chunked(xh, dt, a, b_, c_, d_skip, 256)

    def bf16(t):
        return t.to(torch.bfloat16).to(torch.float32)

    w = bf16((c_ * b_).sum(-1)[..., None] * dt)            # (B, 1, NH)
    want = w[..., None] * bf16(xh) + d_skip[None, None, :, None] * xh
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)
    assert not torch.allclose(y, (c_ * b_).sum(-1)[..., None, None]
                              * dt[..., None] * xh
                              + d_skip[None, None, :, None] * xh,
                              rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s", [2, 16])
def test_ssm_block_prefill_and_decode_match_jax(jax_mods, s):
    """`ssm_block` prefill (its output and fresh conv / state caches; s=2
    left-pads the conv cache), then one decode step on stacked caches of
    two layers at layer 1, updated in place."""
    j = jax_mods
    cfg_j = j.configs.reduced_config(j.configs.get_config("mamba2-1.3b"))
    cfg_t = reduced_config(get_config("mamba2-1.3b"))
    p_j = j.ssm.init_ssm(j.jax.random.PRNGKey(s), cfg_j, j.jnp.float32)
    p_np = _np_tree(j, p_j)
    p_t = _t_tree(p_np)
    rng = np.random.default_rng(s)
    x = rng.normal(size=(B, s, cfg_t.d_model)).astype(np.float32)
    tok = rng.normal(size=(B, 1, cfg_t.d_model)).astype(np.float32)

    want, (jc, js) = j.ssm.ssm_block(p_j, cfg_j, j.jnp.asarray(x))
    got, (tc, ts) = ssm.ssm_block(p_t, cfg_t, torch.as_tensor(x))
    assert tc.shape == (B, cfg_t.ssm_conv - 1, ssm.conv_channels(cfg_t))
    _close(got, want)
    _close(tc, jc)
    _close(ts, js)
    if s < cfg_t.ssm_conv - 1:
        assert not tc[:, :cfg_t.ssm_conv - 1 - s].any()

    conv_j = j.jnp.stack([j.jnp.zeros_like(jc), jc])
    state_j = j.jnp.stack([j.jnp.zeros_like(js), js])
    want_d, (wc, ws) = j.ssm.ssm_block(p_j, cfg_j, j.jnp.asarray(tok),
                                       cache=(conv_j, state_j),
                                       cache_layer=1)
    stacks = (torch.stack([torch.zeros_like(tc), tc]),
              torch.stack([torch.zeros_like(ts), ts]))
    got_d, (gc, gs) = ssm.ssm_block(p_t, cfg_t, torch.as_tensor(tok),
                                    cache=stacks, cache_layer=1)
    assert gc is stacks[0] and gs is stacks[1]          # in place
    _close(got_d, want_d)
    _close(gc, wc)
    _close(gs, ws)


# ---------------------------------------------------------------------------
# the model: mamba2-1.3b, zamba2-7b, and a hybrid with a tail
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=MODELS, ids=[m[0] for m in MODELS])
def pair(request, jax_mods):
    """One configuration on both sides: the JAX parameters, the port's copy
    of them and a numpy prompt."""
    name, arch, over = request.param
    j = jax_mods
    cfg_j = j.configs.reduced_config(j.configs.get_config(arch), **over)
    cfg_t = reduced_config(get_config(arch), **over)
    params_j = j.tf.init_params(j.jax.random.PRNGKey(0), cfg_j)
    params_t = convert.lm_params_from_arrays(_np_tree(j, params_j), cfg_t,
                                             device="cpu")
    rng = np.random.default_rng(len(name))
    tokens = rng.integers(0, cfg_t.vocab_size, (B, S)).astype(np.int32)
    return types.SimpleNamespace(name=name, cfg_j=cfg_j, cfg_t=cfg_t,
                                 params_j=params_j, params_t=params_t,
                                 tokens=tokens)


@pytest.mark.parametrize("n_layers,every", [(81, 6), (6, 3), (7, 3)])
def test_hybrid_layout_matches_jax(jax_mods, n_layers, every):
    """(n_super, per_super, tail): zamba2-7b's 13 x 6 + 3, the reduced
    config's 2 x 3 + 0 and the tail config's 2 x 3 + 1."""
    over = {"n_layers": n_layers, "shared_attn_every": every}
    cfg_t = dataclasses.replace(get_config("zamba2-7b"), **over)
    cfg_j = dataclasses.replace(
        jax_mods.configs.get_config("zamba2-7b"), **over)
    assert transformer.hybrid_layout(cfg_t) == \
        jax_mods.tf.hybrid_layout(cfg_j)


def test_init_params_and_caches_have_jax_layout(jax_mods, pair):
    """The port's own random parameters and decode caches have the JAX
    package's tree, shapes and dtypes."""
    j = jax_mods

    def spec(tree):
        return j.jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                              tree)

    def t_spec(tree):
        if isinstance(tree, dict):
            return {k: t_spec(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(t_spec(v) for v in tree)
        return (tuple(tree.shape), str(tree.dtype)[6:])

    own = transformer.init_params(1, pair.cfg_t, device="cpu")
    assert t_spec(own) == spec(pair.params_j)
    assert t_spec(lm.init_caches(pair.cfg_t, B, S_MAX, device="cpu")) == \
        spec(j.lm.init_caches(pair.cfg_j, B, S_MAX))


def test_forward_hidden_matches_jax(jax_mods, pair):
    want, _, _ = jax_mods.tf.forward(pair.params_j, pair.cfg_j,
                                     jax_mods.jnp.asarray(pair.tokens))
    got, _, aux = transformer.forward(pair.params_t, pair.cfg_t,
                                      torch.as_tensor(pair.tokens))
    assert got.shape == (B, S, pair.cfg_t.d_model)
    assert aux.dtype == torch.float32 and float(aux) == 0.0
    _close(got, want, MODEL_TOL)


def test_prefill_and_extended_caches_match_jax(jax_mods, pair):
    """Prefill's logits and caches in the JAX package's prefill layout (the
    hybrid's grouped by super-block), `extend_caches` of both, and the
    port's prefill straight into s_max slots equal to the extended caches
    bit for bit."""
    j = jax_mods
    want_logits, jc = j.lm.prefill(pair.params_j, pair.cfg_j,
                                   {"tokens": j.jnp.asarray(pair.tokens)})
    batch = {"tokens": torch.as_tensor(pair.tokens)}
    got_logits, tc = lm.prefill(pair.params_t, pair.cfg_t, batch)
    _close(got_logits, want_logits, MODEL_TOL)
    _close_tree(tc, _np_tree(j, jc))
    want_ext = _np_tree(j, j.lm.extend_caches(pair.cfg_j, jc, S_MAX))
    ext = lm.extend_caches(pair.cfg_t, tc, S_MAX)
    _close_tree(ext, want_ext)
    direct_logits, direct = lm.prefill(pair.params_t, pair.cfg_t, batch,
                                       s_max=S_MAX)
    assert torch.equal(direct_logits, got_logits)
    assert set(direct) == set(ext)
    for key in direct:
        for a, b in zip(direct[key], ext[key]):
            assert torch.equal(a, b), key


def test_decode_step_matches_jax(jax_mods, pair):
    """One decode step at position S after a prefill, on both sides: the
    logits and every cache, the SSM ones updated in place."""
    j = jax_mods
    _, jc = j.lm.prefill(pair.params_j, pair.cfg_j,
                         {"tokens": j.jnp.asarray(pair.tokens)})
    jc = j.lm.extend_caches(pair.cfg_j, jc, S_MAX)
    token = np.arange(B, dtype=np.int32)[:, None] + 7
    want, jc = j.lm.decode_step(pair.params_j, pair.cfg_j,
                                j.jnp.asarray(token), jc, j.jnp.int32(S))
    _, tc = lm.prefill(pair.params_t, pair.cfg_t,
                       {"tokens": torch.as_tensor(pair.tokens)}, s_max=S_MAX)
    conv = tc["ssm"][0]
    got, tc2 = lm.decode_step(pair.params_t, pair.cfg_t,
                              torch.as_tensor(token), tc, S)
    assert tc2["ssm"][0] is conv                        # written in place
    _close(got, want, MODEL_TOL)
    _close_tree(tc2, _np_tree(j, jc))


def test_greedy_generate_matches_jax(jax_mods, pair):
    j = jax_mods
    want = j.serve.generate(pair.params_j, pair.cfg_j,
                            {"tokens": j.jnp.asarray(pair.tokens)},
                            n_tokens=N_TOKENS, s_max=S_MAX)
    got = lm_serve.generate(pair.params_t, pair.cfg_t,
                            {"tokens": torch.as_tensor(pair.tokens)},
                            n_tokens=N_TOKENS, s_max=S_MAX)
    assert got.dtype == torch.int32 and got.shape == (B, N_TOKENS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_decode_matches_fresh_prefill(arch):
    """Decoding the last token after a prefill of the others gives the
    last-position logits of a prefill over all of them, at the model
    tolerance: decode runs the exact float32 recurrence where the prefill
    rounds the SSD weight block to bf16."""
    cfg = reduced_config(get_config(arch))
    params = transformer.init_params(0, cfg, device="cpu")
    tok = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, 24)))
    full, _ = lm.prefill(params, cfg, {"tokens": tok})
    _, caches = lm.prefill(params, cfg, {"tokens": tok[:, :-1]}, s_max=28)
    got, _ = lm.decode_step(params, cfg, tok[:, -1:], caches, 23)
    torch.testing.assert_close(got, full, rtol=MODEL_TOL, atol=MODEL_TOL)


def test_convert_keeps_float32_ssm_params(jax_mods):
    """Under a bfloat16 config the JAX package keeps `a_log`, `d_skip` and
    `dt_bias` float32; the converted tree keeps every array's own width."""
    j = jax_mods
    cfg_j = j.configs.reduced_config(j.configs.get_config("zamba2-7b"),
                                     dtype="bfloat16")
    cfg_t = reduced_config(get_config("zamba2-7b"), dtype="bfloat16")
    params_j = j.tf.init_params(j.jax.random.PRNGKey(0), cfg_j)
    params_t = convert.lm_params_from_arrays(_np_tree(j, params_j), cfg_t,
                                             device="cpu")
    layer = params_t["layers"]["ssm"]
    for name in ("a_log", "d_skip", "dt_bias"):
        assert layer[name].dtype == torch.float32, name
    for name in ("z_proj", "conv_x_w", "norm_w", "out_proj"):
        assert layer[name].dtype == torch.bfloat16, name
    assert params_t["shared"]["attn"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params_t["shared"]["ffn"]["wi"].float().numpy(),
        np.asarray(params_j["shared"]["ffn"]["wi"], np.float32))
    with pytest.raises(ValueError, match="shared"):
        convert.lm_params_from_arrays(
            {k: v for k, v in _np_tree(j, params_j).items() if k != "shared"},
            cfg_t, device="cpu")


def test_bf16_decode_spread_is_the_jax_packages(jax_mods):
    """In bfloat16 decode and a fresh prefill differ by more than in
    float32 in both packages: decode runs the exact float32 recurrence and
    a one-step conv einsum where the prefill rounds the SSD weight block
    and x to bf16 and the conv after every tap, and the layers carry the
    differences on. A reduced mamba2-1.3b in bf16 (12 layers, d_model
    256): 16 tokens decoded after a prefill of 16, the last step's logits
    against a fresh prefill of 32. The port's spread is the JAX package's
    within a factor 1.5 (2.75% and 2.84% of the largest logit), and the
    port's decode logits lie within that of JAX's (2.37%)."""
    j = jax_mods
    over = dict(dtype="bfloat16", n_layers=12, d_model=256)
    cfg_j = j.configs.reduced_config(j.configs.get_config("mamba2-1.3b"),
                                     **over)
    cfg_t = reduced_config(get_config("mamba2-1.3b"), **over)
    params_j = j.tf.init_params(j.jax.random.PRNGKey(0), cfg_j)
    params_t = convert.lm_params_from_arrays(_np_tree(j, params_j), cfg_t,
                                             device="cpu")
    tok = np.random.default_rng(0).integers(0, cfg_t.vocab_size,
                                            (B, 32)).astype(np.int32)
    head = 16

    full_j, _ = j.lm.prefill(params_j, cfg_j, {"tokens": j.jnp.asarray(tok)})
    _, caches = j.lm.prefill(params_j, cfg_j,
                             {"tokens": j.jnp.asarray(tok[:, :head])})
    caches = j.lm.extend_caches(cfg_j, caches, S_MAX)
    step = j.jax.jit(lambda p, t, c, pos: j.lm.decode_step(p, cfg_j, t, c,
                                                           pos))
    for pos in range(head, 32):
        dec_j, caches = step(params_j, j.jnp.asarray(tok[:, pos:pos + 1]),
                             caches, j.jnp.int32(pos))
    full_t, _ = lm.prefill(params_t, cfg_t, {"tokens": torch.as_tensor(tok)})
    _, tc = lm.prefill(params_t, cfg_t,
                       {"tokens": torch.as_tensor(tok[:, :head])},
                       s_max=S_MAX)
    for pos in range(head, 32):
        dec_t, tc = lm.decode_step(params_t, cfg_t,
                                   torch.as_tensor(tok[:, pos:pos + 1]), tc,
                                   pos)

    def last(t):
        return np.asarray(t, np.float32)[:, -1]

    full_j, dec_j = last(full_j), last(dec_j)
    full_t, dec_t = last(full_t.float()), last(dec_t.float())
    scale = np.abs(full_j).max()
    spread_j = np.abs(dec_j - full_j).max() / scale
    spread_t = np.abs(dec_t - full_t).max() / scale
    assert 0 < spread_j < 0.05 and spread_t <= 1.5 * spread_j
    assert np.abs(dec_t - dec_j).max() / scale <= 1.5 * spread_j


def test_ssd_gradient_is_finite_where_the_decay_overflows(jax_mods):
    """One chunk of 128 positions whose cumulative decay falls past -88:
    above the diagonal exp(diff) overflows. The port masks the decay
    before its exp, so its forward is the JAX package's (within
    MODEL_TOL: a 128-position weight block rounded to bf16 flips a few
    roundings) and its gradient is finite, where the reference's
    where(tril, exp(diff), 0) gives a NaN gradient (0 * inf)."""
    jax, jnp = jax_mods.jax, jax_mods.jnp
    xh, dt, a, b_, c_, d_skip = _ssd_inputs(5, 128)
    dt = dt + 1.0                               # cum over 128 < -88
    args = (xh, dt, a, b_, c_, d_skip)

    def j_loss(*t):
        return jnp.sum(jax_mods.ssm.ssd_chunked(*t, 128)[0])

    want_y, _ = jax_mods.ssm.ssd_chunked(*(jnp.asarray(t) for t in args),
                                         128)
    want_g = jax.grad(j_loss, argnums=1)(*(jnp.asarray(t) for t in args))
    assert not np.isfinite(np.asarray(want_g)).all()
    got = [torch.as_tensor(t) for t in args]
    got[1].requires_grad_(True)
    y, _ = ssm.ssd_chunked(*got, 128)
    _close(y.detach(), want_y, MODEL_TOL)
    y.sum().backward()
    assert torch.isfinite(got[1].grad).all()
