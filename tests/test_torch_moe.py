"""The port's MoE layers (`repro_torch.models.moe`, the `attn_moe` kind of
`models/transformer.py`) and the MoE serving path held to the JAX package
on the CPU, on the JAX package's own parameters carried across with
`convert.lm_params_from_arrays`. Three configurations: grok-1-314b and
kimi-k2-1t-a32b at their reduced float32 configs (2 layers, d_model 64, 4
experts of d_ff 64, top 2; grok GeLU with softcap 30 and capacity factor
1.25, kimi SwiGLU at 1.0) and a kimi with 16 experts, top 8, for the
combine's order of addition at k = 8.

Tolerances (float32 throughout):
- routing: the expert ids equal; gates, router logits and the aux loss
  within rtol = atol = 1e-5 (XLA's and PyTorch's float32 products sum in
  other orders).
- dispatch and combine, given the JAX package's route (and, for the
  combine, its expert outputs): equal, bit for bit. The combine adds a
  token's k weighted outputs in increasing expert id, the order of the JAX
  package's scatter-add.
- `moe_block`, `forward` (hidden and aux), `prefill` logits and caches and
  `decode_step` at the config's own capacity: rtol = atol = 1e-5, as
  `tests/test_torch_lm.py`; the largest difference measured is 3.6e-6, on
  hidden states up to 3.6. Both sides drop picks there: the prefills (T =
  64) 10 to 90 a layer, the kimis' decode steps (T = B = 2, capacity 1)
  1 and 5 a layer.
- greedy `generate` tokens: equal. The decode logits agree to 2.4e-6, far
  inside the smallest gap between a row's two largest logits (0.061).

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
from repro_torch.models import lm, moe, transformer
from repro_torch.runtime import lm_serve

TOL = 1e-5
B, S, S_MAX, N_TOKENS = 2, 32, 48, 6
# (name, arch, overrides of reduced_config)
MODELS = [("grok-1-314b", "grok-1-314b", {}),
          ("kimi-k2-1t-a32b", "kimi-k2-1t-a32b", {}),
          ("kimi-top8", "kimi-k2-1t-a32b",
           {"n_experts": 16, "experts_per_token": 8})]
# (name, model, capacity_factor): the three at their own capacity, and the
# top-8 kimi at a quarter of it, which drops three picks in four
BLOCKS = [(name, name, None) for name, _, _ in MODELS] + [
    ("kimi-top8-drops", "kimi-top8", 0.25)]


@pytest.fixture(scope="module")
def jax_mods():
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.models import lm as j_lm
    from repro.models import moe as j_moe
    from repro.models import transformer as j_tf
    from repro.runtime import lm_serve as j_serve
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, configs=configs,
                                 lm=j_lm, moe=j_moe, tf=j_tf, serve=j_serve)


def _configs(j, model: str, capacity_factor=None):
    _, arch, over = next(m for m in MODELS if m[0] == model)
    if capacity_factor is not None:
        over = dict(over, capacity_factor=capacity_factor)
    return (j.configs.reduced_config(j.configs.get_config(arch), **over),
            reduced_config(get_config(arch), **over))


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _equal(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module", params=[b[0] for b in BLOCKS])
def block(request, jax_mods):
    """One MoE block on both sides: configs, the JAX parameters of
    `init_moe` and the port's copy, an input x (B, S, D) and the JAX
    package's route of it."""
    j = jax_mods
    _, model, cf = next(b for b in BLOCKS if b[0] == request.param)
    cfg_j, cfg_t = _configs(j, model, cf)
    params_j = j.moe.init_moe(j.jax.random.PRNGKey(3), cfg_j, j.jnp.float32)
    params_t = {k: _t(v) for k, v in params_j.items()}
    x = np.random.default_rng(len(request.param)).normal(
        size=(B, S, cfg_t.d_model)).astype(np.float32)
    xf = x.reshape(B * S, -1)
    route = j.moe._route(params_j["router"], cfg_j, j.jnp.asarray(xf))
    return types.SimpleNamespace(cfg_j=cfg_j, cfg_t=cfg_t, params_j=params_j,
                                 params_t=params_t, x=x, xf=xf, route=route)


def test_init_moe_matches_the_jax_tree(jax_mods, block):
    """Same keys, shapes and dtypes as the JAX package's `init_moe`, the
    router float32 in a bfloat16 model, the experts drawn at their std."""
    cfg = block.cfg_t
    got = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                       lead=(3,))
    want = jax_mods.moe.init_moe(jax_mods.jax.random.PRNGKey(0),
                                 block.cfg_j, jax_mods.jnp.bfloat16)
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == (3, *want[k].shape)
        assert str(v.dtype)[6:] == str(want[k].dtype)
    assert got["router"].dtype == torch.float32
    d, ff = cfg.d_model, cfg.moe_d_ff
    for k, std in (("wi", d ** -0.5), ("wo", ff ** -0.5)):
        assert abs(float(got[k].float().std()) / std - 1) < 0.05
    # drawn one expert slice at a time: layers and experts differ
    assert not torch.equal(got["wi"][0, 0], got["wi"][0, 1])
    assert not torch.equal(got["wi"][0, 0], got["wi"][1, 0])


def test_route_matches_jax(jax_mods, block):
    gates_j, eids_j, aux_j = block.route
    gates, eids, aux = moe._route(block.params_t["router"], block.cfg_t,
                                  torch.as_tensor(block.xf))
    k = block.cfg_t.experts_per_token
    assert eids.shape == (B * S, k) and gates.dtype == torch.float32
    _equal(eids, eids_j)
    _close(gates, gates_j)
    _close(aux, aux_j)
    _close(torch.as_tensor(block.xf) @ block.params_t["router"],
           block.xf @ np.asarray(block.params_j["router"]))


def test_route_breaks_ties_toward_the_lower_expert(jax_mods, block):
    """Experts 1 and 2 share their router column (and 0 and 3 for the
    top-8 kimi), so their logits tie exactly: `lax.top_k` and the port
    take the lower id first."""
    router = np.array(block.params_j["router"])
    router[:, 2] = router[:, 1]
    router[:, 3] = router[:, 0]
    _, eids_j, _ = jax_mods.moe._route(jax_mods.jnp.asarray(router),
                                       block.cfg_j,
                                       jax_mods.jnp.asarray(block.xf))
    _, eids, _ = moe._route(torch.as_tensor(router), block.cfg_t,
                            torch.as_tensor(block.xf))
    _equal(eids, eids_j)
    e = np.asarray(eids_j)
    # where both of a tied pair are picked, the lower comes first
    for lo, hi in ((1, 2), (0, 3)):
        both = (e == lo).any(1) & (e == hi).any(1)
        assert both.any()
        assert ((np.argmax(e == lo, 1) < np.argmax(e == hi, 1))[both]).all()


def test_dispatch_matches_jax_bit_for_bit(jax_mods, block):
    """Given the JAX package's expert ids: the (E, C, D) buffer, keep, slot
    and token_of equal; the forced case drops most picks."""
    _, eids_j, _ = block.route
    t = B * S
    cap = moe._capacity(block.cfg_t, t)
    assert cap == jax_mods.moe._capacity(block.cfg_j, t)
    want = jax_mods.moe._dispatch(block.cfg_j, jax_mods.jnp.asarray(block.xf),
                                  eids_j, cap)
    got = moe._dispatch(block.cfg_t, torch.as_tensor(block.xf), _t(eids_j),
                        cap)
    assert got[0].shape == (block.cfg_t.n_experts, cap, block.cfg_t.d_model)
    for g, w in zip(got, want):
        _equal(g, w)
    if block.cfg_t.capacity_factor < 1:
        assert 0 < int(got[1].sum()) < t * block.cfg_t.experts_per_token // 2


def test_combine_matches_jax_bit_for_bit(jax_mods, block, monkeypatch):
    """`_moe_local` on both sides with the route and the expert outputs
    fixed to the JAX package's: dispatch and combine alone make the
    output, and it equals JAX's bit for bit (drops included)."""
    j = jax_mods
    gates_j, eids_j, aux_j = block.route
    cap = moe._capacity(block.cfg_t, B * S)
    buf_j = j.moe._dispatch(block.cfg_j, j.jnp.asarray(block.xf), eids_j,
                            cap)[0]
    p = block.params_j
    out_j = j.moe._expert_ffn(block.cfg_j, buf_j, p["wi"], p.get("wg"),
                              p["wo"])
    monkeypatch.setattr(j.moe, "_route", lambda *a: (gates_j, eids_j, aux_j))
    monkeypatch.setattr(j.moe, "_expert_ffn", lambda *a: out_j)
    monkeypatch.setattr(moe, "_route",
                        lambda *a: (_t(gates_j), _t(eids_j), _t(aux_j)))
    monkeypatch.setattr(moe, "_expert_ffn", lambda *a: _t(out_j))
    want, _ = j.moe._moe_local(p, block.cfg_j, j.jnp.asarray(block.x))
    got, _ = moe._moe_local(block.params_t, block.cfg_t,
                            torch.as_tensor(block.x))
    assert got.dtype == torch.float32 and got.shape == block.x.shape
    _equal(got, want)


def test_moe_block_matches_jax(jax_mods, block):
    want, aux_j = jax_mods.moe.moe_block(block.params_j, block.cfg_j,
                                         jax_mods.jnp.asarray(block.x))
    got, aux = moe.moe_block(block.params_t, block.cfg_t,
                             torch.as_tensor(block.x))
    _close(got, want)
    _close(aux, aux_j)


def test_capacity_is_the_jax_expression(jax_mods):
    """`_capacity` in Python floats, the JAX expression's order, for the
    full configs' prefill and decode token counts and the reduced ones."""
    for arch in ("grok-1-314b", "kimi-k2-1t-a32b"):
        for over in ({}, {"capacity_factor": 0.25}, {"n_experts": 16}):
            cfg_t = dataclasses.replace(get_config(arch), **over)
            cfg_j = dataclasses.replace(jax_mods.configs.get_config(arch),
                                        **over)
            for t in (1, 2, 4, 64, 16384, 16388):
                assert moe._capacity(cfg_t, t) == \
                    jax_mods.moe._capacity(cfg_j, t)
    assert moe._capacity(get_config("grok-1-314b"), 4) == 2
    assert moe._capacity(get_config("kimi-k2-1t-a32b"), 4) == 1
    assert moe._capacity(get_config("kimi-k2-1t-a32b"), 16384) == 342


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[m[0] for m in MODELS])
def pair(request, jax_mods):
    """One MoE model on both sides: configs, the JAX parameters and the
    port's copy of them, and a numpy prompt."""
    j = jax_mods
    cfg_j, cfg_t = _configs(j, request.param)
    params_j = j.tf.init_params(j.jax.random.PRNGKey(0), cfg_j)
    params_np = j.jax.tree.map(np.asarray, params_j)
    params_t = convert.lm_params_from_arrays(params_np, cfg_t, device="cpu")
    tokens = np.random.default_rng(len(request.param)).integers(
        0, cfg_t.vocab_size, (B, S)).astype(np.int32)
    return types.SimpleNamespace(cfg_j=cfg_j, cfg_t=cfg_t, params_j=params_j,
                                 params_np=params_np, params_t=params_t,
                                 tokens=tokens)


def test_convert_carries_the_moe_ffn(jax_mods, pair):
    """`layers.ffn` comes across as {router, wi, [wg,] wo}; the JAX
    package's bfloat16 tree keeps its router float32 on both sides; a tree
    without the router is refused."""
    j = jax_mods
    ffn = pair.params_t["layers"]["ffn"]
    glu = pair.cfg_t.act == "swiglu"
    assert set(ffn) == {"router", "wi", "wo"} | ({"wg"} if glu else set())
    for k, v in pair.params_np["layers"]["ffn"].items():
        _equal(ffn[k], v)
    tree16 = j.jax.tree.map(np.asarray, j.tf.init_params(
        j.jax.random.PRNGKey(0), pair.cfg_j, j.jnp.bfloat16))
    cfg16 = dataclasses.replace(pair.cfg_t, dtype="bfloat16")
    back = convert.lm_params_from_arrays(tree16, cfg16, device="cpu")["layers"]
    assert back["ffn"]["router"].dtype == torch.float32
    assert back["ffn"]["wi"].dtype == back["attn"]["wq"].dtype \
        == torch.bfloat16
    _equal(back["ffn"]["wi"].float(),
           tree16["layers"]["ffn"]["wi"].astype(np.float32))
    del tree16["layers"]["ffn"]["router"]
    with pytest.raises(ValueError, match="router"):
        convert.lm_params_from_arrays(tree16, cfg16, device="cpu")


def test_forward_hidden_and_aux_match_jax(jax_mods, pair):
    want, _, aux_j = jax_mods.tf.forward(pair.params_j, pair.cfg_j,
                                         jax_mods.jnp.asarray(pair.tokens))
    got, _, aux = transformer.forward(pair.params_t, pair.cfg_t,
                                      torch.as_tensor(pair.tokens))
    assert got.shape == (B, S, pair.cfg_t.d_model)
    assert aux.dtype == torch.float32 and aux.shape == ()
    _close(got, want)
    _close(aux, aux_j)
    # a decode step's aux is 0.0, as the JAX package's
    caches = lm.init_caches(pair.cfg_t, B, S_MAX, device="cpu")
    _, _, aux_d = transformer.forward(pair.params_t, pair.cfg_t,
                                      torch.as_tensor(pair.tokens[:, :1]),
                                      caches=caches, pos0=0)
    assert float(aux_d) == 0.0


def test_prefill_logits_and_caches_match_jax(jax_mods, pair):
    j = jax_mods
    want_logits, want_caches = j.lm.prefill(
        pair.params_j, pair.cfg_j, {"tokens": j.jnp.asarray(pair.tokens)})
    got_logits, got_caches = lm.prefill(
        pair.params_t, pair.cfg_t, {"tokens": torch.as_tensor(pair.tokens)})
    assert got_logits.shape == (B, 1, pair.cfg_t.padded_vocab)
    _close(got_logits, want_logits)
    for got, want in zip(got_caches["kv"], want_caches["kv"]):
        assert got.shape == (pair.cfg_t.n_layers, B, S, pair.cfg_t.n_kv_heads,
                             pair.cfg_t.head_dim)
        _close(got, want)


def test_decode_step_matches_jax(jax_mods, pair):
    """One decode step at position S after a prefill, at the config's own
    decode capacity (both kimis: 1, so colliding picks are dropped)."""
    j = jax_mods
    _, jc = j.lm.prefill(pair.params_j, pair.cfg_j,
                         {"tokens": j.jnp.asarray(pair.tokens)})
    jc = j.lm.extend_caches(pair.cfg_j, jc, S_MAX)
    token = np.arange(B, dtype=np.int32)[:, None] + 7
    want, jc = j.lm.decode_step(pair.params_j, pair.cfg_j,
                                j.jnp.asarray(token), jc, j.jnp.int32(S))
    _, tc = lm.prefill(pair.params_t, pair.cfg_t,
                       {"tokens": torch.as_tensor(pair.tokens)},
                       s_max=S_MAX)
    got, tc2 = lm.decode_step(pair.params_t, pair.cfg_t,
                              torch.as_tensor(token), tc, S)
    assert tc2["kv"][0] is tc["kv"][0]          # written in place
    _close(got, want)
    for got_c, want_c in zip(tc2["kv"], jc["kv"]):
        _close(got_c, want_c)


def test_greedy_generate_matches_jax(jax_mods, pair):
    j = jax_mods
    want = j.serve.generate(pair.params_j, pair.cfg_j,
                            {"tokens": j.jnp.asarray(pair.tokens)},
                            n_tokens=N_TOKENS, s_max=S_MAX)
    got = lm_serve.generate(pair.params_t, pair.cfg_t,
                            {"tokens": torch.as_tensor(pair.tokens)},
                            n_tokens=N_TOKENS, s_max=S_MAX)
    assert got.dtype == torch.int32 and got.shape == (B, N_TOKENS)
    _equal(got, want)
    again = lm_serve.generate(pair.params_t, pair.cfg_t,
                              {"tokens": torch.as_tensor(pair.tokens)},
                              n_tokens=N_TOKENS, s_max=S_MAX)
    assert torch.equal(got, again)


def test_decode_matches_fresh_prefill():
    """The port against itself: decoding the last token after a prefill of
    the others gives the logits of a prefill over all of them. At a
    capacity factor of 2 no expert can overflow (C >= T, for prefill and
    decode alike), so both runs keep every pick."""
    cfg = reduced_config(get_config("grok-1-314b"), capacity_factor=2.0)
    params = transformer.init_params(0, cfg, device="cpu")
    tok = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, 24)))
    full, _ = lm.prefill(params, cfg, {"tokens": tok})
    _, caches = lm.prefill(params, cfg, {"tokens": tok[:, :-1]}, s_max=28)
    got, _ = lm.decode_step(params, cfg, tok[:, -1:], caches, 23)
    torch.testing.assert_close(got, full, rtol=TOL, atol=TOL)
