"""Parity of the port's data, training, layout, encoding and area modules
with the JAX package (`repro`), on the CPU. Tolerance: exact equality."""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import area as j_area
from repro.core import quant as j_quant
from repro.core import train as j_train
from repro.core import tree as j_tree
from repro.datasets import synthetic as j_syn
from repro_torch.core import area as t_area
from repro_torch.core import quant as t_quant
from repro_torch.core import train as t_train
from repro_torch.core import tree as t_tree
from repro_torch.datasets import synthetic as t_syn

TREE_DATASETS = ("seeds", "vertebral", "balance", "mammographic")


@pytest.mark.parametrize("name", sorted(j_syn.DATASET_SPECS))
def test_dataset_arrays_equal(name):
    assert (dataclasses.astuple(t_syn.DATASET_SPECS[name])
            == dataclasses.astuple(j_syn.DATASET_SPECS[name]))
    j = j_syn.load_dataset(name)
    t = t_syn.load_dataset(name)
    for field in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(j, field), getattr(t, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert j.n_classes == t.n_classes
    np.testing.assert_array_equal(j_syn.quantize_u8(j.x_test),
                                  t_syn.quantize_u8(t.x_test))


def _trees(name):
    ds = t_syn.load_dataset(name)
    j = j_train.train_tree(ds.x_train, ds.y_train, ds.n_classes)
    t = t_train.train_tree(ds.x_train, ds.y_train, ds.n_classes)
    return ds, j, t


@pytest.mark.parametrize("name", TREE_DATASETS)
def test_trained_trees_and_parallel_form_equal(name):
    ds, j, t = _trees(name)
    for field in ("feature", "threshold", "left", "right", "leaf_class"):
        np.testing.assert_array_equal(getattr(j, field), getattr(t, field))
    np.testing.assert_array_equal(j_train.predict_numpy(j, ds.x_test),
                                  t_train.predict_numpy(t, ds.x_test))
    pj, pt = j_tree.to_parallel(j), t_tree.to_parallel(t)
    for field in ("feature", "threshold", "path", "path_len", "n_neg",
                  "leaf_class"):
        a, b = getattr(pj, field), getattr(pt, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    cj, ct = j_tree.concatenate_ptrees([pj]), t_tree.concatenate_ptrees([pt])
    assert cj.keys() == ct.keys()
    for key in cj:
        np.testing.assert_array_equal(cj[key], ct[key])


@pytest.mark.parametrize("name", TREE_DATASETS)
def test_descent_oracle_equal(name):
    ds, j, t = _trees(name)
    rng = np.random.default_rng(3)
    x8 = t_syn.quantize_u8(ds.x_test).astype(np.int32)
    bits = rng.integers(2, 9, t.n_nodes)
    margin = rng.integers(-5, 6, t.n_nodes)
    np.testing.assert_array_equal(
        j_tree.predict_descent_quantized(x8, j, bits, margin),
        t_tree.predict_descent_quantized(x8, t, bits, margin))


@pytest.mark.parametrize("seed,n_comp", [(0, 1), (1, 7), (2, 64), (3, 225)])
def test_decode_tree_genes_equal(seed, n_comp):
    rng = np.random.default_rng(seed)
    genes = rng.random((33, 3 * n_comp + 1), dtype=np.float32)
    genes[0] = t_quant.exact_tree_genes(n_comp)
    genes[1, ::2] = 1.0           # the top of every gene range
    genes[2, :] = 0.0
    j_out = j_quant.decode_tree_genes(jnp.asarray(genes))
    t_out = t_quant.decode_tree_genes(torch.as_tensor(genes))
    for a, b in zip(j_out, t_out):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(j_quant.exact_tree_genes(n_comp),
                                  t_quant.exact_tree_genes(n_comp))


def test_threshold_substitution_and_precision_equal():
    rng = np.random.default_rng(5)
    thr = rng.random(500, dtype=np.float32)
    thr[:4] = [0.0, 0.99999994, 0.5, (255 + 0.5) / 256]
    bits = rng.integers(0, 9, 500).astype(np.int32)
    margin = rng.integers(-5, 6, 500).astype(np.int32)
    x8 = rng.integers(0, 256, (40, 500)).astype(np.int32)
    j_t = j_quant.threshold_to_int(jnp.asarray(thr), jnp.asarray(bits))
    t_t = t_quant.threshold_to_int(torch.as_tensor(thr), torch.as_tensor(bits))
    np.testing.assert_array_equal(np.asarray(j_t), t_t.numpy())
    j_s = j_quant.substitute(j_t, jnp.asarray(margin), jnp.asarray(bits))
    t_s = t_quant.substitute(t_t, torch.as_tensor(margin), torch.as_tensor(bits))
    np.testing.assert_array_equal(np.asarray(j_s), t_s.numpy())
    np.testing.assert_array_equal(
        np.asarray(j_quant.inputs_at_precision(jnp.asarray(x8),
                                               jnp.asarray(bits))),
        t_quant.inputs_at_precision(torch.as_tensor(x8),
                                    torch.as_tensor(bits)).numpy())


@pytest.mark.parametrize("which", ["build_area_lut", "build_area_unit_lut"])
def test_area_luts_equal(which):
    j_lut, j_off = getattr(j_area, which)()
    t_lut, t_off = getattr(t_area, which)()
    assert j_lut.dtype == t_lut.dtype and np.array_equal(j_lut, t_lut)
    np.testing.assert_array_equal(j_off, t_off)


def test_area_scalars_equal():
    for t in range(256):
        for p in range(9):
            if t < (1 << p):
                assert (j_area.comparator_gate_counts(t, p)
                        == t_area.comparator_gate_counts(t, p))
    assert j_area.gate_area_mm2(3, 4, 5, 6) == t_area.gate_area_mm2(3, 4, 5, 6)
    assert j_area.tree_overhead_mm2(7, 8) == t_area.tree_overhead_mm2(7, 8)
    assert (t_area.tree_overhead_units(7, 8) * t_area.AREA_QUANTUM_MM2
            == pytest.approx(j_area.tree_overhead_mm2(7, 8), abs=1e-12))
    assert j_area.power_mw(12.5) == t_area.power_mw(12.5)
