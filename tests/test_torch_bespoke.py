"""The LM half of the port's `quantize.bespoke` held to the JAX package's
on the CPU: the quantizable tensors' names (JAX's tree paths), the
per-channel codes and scales at several (bits, margin), the codes' cost,
`apply_chromosome`'s dequantized weights and total cost, all equal; and
`make_lm_quant_problem`'s base loss and objectives (through each package's
`lm_loss`) within 1e-5, the losses' tolerance of
`tests/test_torch_train.py`. Both sides compute the codes in numpy from
float32 copies, so only the loss differs, by summation orders.

The JAX package is imported by a fixture, so the machine with the card
(which has no JAX) skips these tests.
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from repro_torch import convert, pytree
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import lm, transformer
from repro_torch.quantize import bespoke

ARCH = "llama3.2-3b"
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
def setup():
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.models import lm as j_lm
    from repro.quantize import bespoke as j_bespoke
    cfg_j = configs.reduced_config(configs.get_config(ARCH))
    cfg_t = reduced_config(get_config(ARCH))
    params_np = pytree.tree_map(lambda t: t.numpy(), transformer.init_params(
        1, cfg_t, device="cpu"))
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, lm=j_lm, bespoke=j_bespoke, cfg_j=cfg_j,
        cfg_t=cfg_t, params_np=params_np,
        params_j=pytree.tree_map(jax.numpy.asarray, params_np),
        params_t=convert.lm_params_from_arrays(params_np, cfg_t,
                                               device="cpu"))


def _pop(setup):
    n = len(bespoke.quantizable_tensors(setup.params_t))
    return np.random.default_rng(3).random((3, 2 * n)).astype(np.float32)


@pytest.mark.parametrize("bits,margin", [(2, 0), (4, 2), (8, 5)])
def test_codes_and_costs_match_jax(setup, bits, margin):
    names_j = [n for n, _ in setup.bespoke.quantizable_tensors(
        setup.params_j)]
    assert [n for n, _ in bespoke.quantizable_tensors(setup.params_t)] == \
        names_j
    assert "layers/ffn/wi" in names_j and not any(
        "norm" in n for n in names_j)
    w = setup.params_np["layers"]["ffn"]["wi"]
    cj, sj = setup.bespoke.quantize_tensor(w, bits, margin)
    ct, st = bespoke.quantize_tensor(torch.as_tensor(np.array(w)), bits,
                                     margin)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(st, sj)
    assert bespoke.tensor_cost(ct, bits) == setup.bespoke.tensor_cost(cj,
                                                                      bits)
    np.testing.assert_array_equal(bespoke.dequantize_tensor(ct, st),
                                  setup.bespoke.dequantize_tensor(cj, sj))


def test_apply_chromosome_matches_jax(setup):
    genes = _pop(setup)[0]
    qj, cost_j = setup.bespoke.apply_chromosome(setup.params_j, genes)
    qt, cost_t = bespoke.apply_chromosome(setup.params_t, genes)
    assert cost_t == cost_j
    for (p, a), b in zip(pytree.leaves_with_paths(qt),
                         setup.jax.tree.leaves(qj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=pytree.path_str(p))
    # the float weights are left as they were
    assert np.array_equal(setup.params_t["layers"]["ffn"]["wi"].numpy(),
                          setup.params_np["layers"]["ffn"]["wi"])


def test_lm_quant_problem_matches_jax(setup):
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, setup.cfg_t.vocab_size, (2, 64)).astype(
        np.int32)
    loss_j = setup.jax.jit(
        lambda p, b: setup.lm.lm_loss(p, setup.cfg_j, b)[0])
    fit_j, n_j, base_j = setup.bespoke.make_lm_quant_problem(
        setup.params_j, setup.cfg_j, {"tokens": setup.jnp.asarray(tokens)},
        loss_j)
    fit_t, n_t, base_t = bespoke.make_lm_quant_problem(
        setup.params_t, setup.cfg_t, {"tokens": torch.as_tensor(tokens)},
        lambda p, b: lm.lm_loss(p, setup.cfg_t, b)[0])
    assert n_t == n_j and abs(base_t - base_j) <= LOSS_TOL
    pop = _pop(setup)
    np.testing.assert_allclose(fit_t(pop), fit_j(pop), rtol=0,
                               atol=LOSS_TOL)
