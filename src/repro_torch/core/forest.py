"""Random forests of bespoke trees (beyond the paper, same machinery).

The counterpart of `repro.core.forest`. A bespoke forest is K parallel
bespoke trees and a majority-vote adder, so the dual approximation applies
per comparator across the whole forest with one chromosome of
3 * sum_k(N_k) + 1 genes, and cross-tree comparator sharing (CSE) makes the
joint search richer than per-tree searches.

The search runs through `repro_torch.search`: `build_forest_problem` lays
the forest out as one block-diagonal super-tree that the kernels evaluate
in one launch. `forest_predict` is the per-tree oracle the fused paths are
held to; `make_forest_fitness` is a thin adapter over the reference
backend; `forest_area_mm2` prices the forest with cross-tree CSE.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import area as area_mod
from repro_torch.core import quant
from repro_torch.core.train import TreeArrays, train_tree
from repro_torch.core.tree import ParallelTree, to_parallel


@dataclasses.dataclass
class Forest:
    trees: list[TreeArrays]
    ptrees: list[ParallelTree]
    n_classes: int

    @property
    def n_comparators(self) -> int:
        return sum(p.n_comparators for p in self.ptrees)

    @property
    def n_genes(self) -> int:
        # 3 genes per comparator plus the forest-level vote-adder gene
        return 3 * self.n_comparators + 1


def train_forest(x, y, n_classes, n_trees=5, seed=0, feature_frac=0.7):
    """Bootstrap-sampled trees over random feature subsets (classic RF),
    with the JAX package's numpy draws, so the trees are its trees."""
    rng = np.random.default_rng(seed)
    n, f = x.shape
    trees = []
    for _ in range(n_trees):
        idx = rng.integers(0, n, n)
        feats = rng.permutation(f)[: max(1, int(f * feature_frac))]
        xb = np.zeros_like(x)
        xb[:, feats] = x[idx][:, feats]
        trees.append(train_tree(xb, y[idx], n_classes))
    return Forest(trees, [to_parallel(t) for t in trees], n_classes)


def forest_predict(forest: Forest, x8, bits_all, marg_all) -> torch.Tensor:
    """Majority vote over the quantized trees, one tree at a time: the
    per-tree oracle the fused paths are held to. ``x8`` (B, F) integer
    codes; ``bits_all``/``marg_all`` the concatenated per-tree decoded
    comparator genes. Runs where ``x8`` lies."""
    x8 = torch.as_tensor(x8).to(torch.int32)
    dev = x8.device
    bits_all = torch.as_tensor(bits_all, device=dev).to(torch.int32)
    marg_all = torch.as_tensor(marg_all, device=dev).to(torch.int32)
    votes = torch.zeros((x8.shape[0], forest.n_classes), dtype=torch.float32,
                        device=dev)
    off = 0
    for pt in forest.ptrees:
        n = pt.n_comparators
        bits = bits_all[off:off + n]
        t_int = quant.substitute(
            quant.threshold_to_int(torch.as_tensor(pt.threshold, device=dev),
                                   bits), marg_all[off:off + n], bits)
        x_p = quant.inputs_at_precision(
            x8[:, torch.as_tensor(pt.feature, device=dev).long()], bits)
        d = (x_p > t_int[None, :]).to(torch.float32)
        path = torch.as_tensor(pt.path, device=dev).to(torch.float32)
        target = torch.as_tensor(pt.path_len - (pt.path == -1).sum(1),
                                 device=dev).to(torch.float32)
        leaf = torch.argmax(d @ path[:, :n].T - target[None, :], dim=1)
        cls = torch.as_tensor(pt.leaf_class, device=dev).long()[leaf]
        votes = votes + torch.nn.functional.one_hot(
            cls, forest.n_classes).to(torch.float32)
        off += n
    return torch.argmax(votes, dim=1)


def forest_area_mm2(forest: Forest, bits_all, marg_all, dedup=True) -> float:
    """Area across all trees; with ``dedup`` identical (feature, t', p)
    comparators are shared forest-wide, as synthesis of the flat netlist
    shares them."""
    feats, t_ints, bits_np = [], [], []
    off = 0
    bits_all = np.asarray(bits_all)
    marg_all = np.asarray(marg_all)
    for pt in forest.ptrees:
        n = pt.n_comparators
        b = bits_all[off:off + n]
        t = np.clip(np.floor(pt.threshold * (2.0 ** b)), 0, (1 << b) - 1)
        t = np.clip(t + marg_all[off:off + n], 0, (1 << b) - 1)
        feats.append(pt.feature)
        t_ints.append(t.astype(np.int64))
        bits_np.append(b)
        off += n
    return float(area_mod.tree_area_mm2(
        np.concatenate(feats), np.concatenate(t_ints),
        np.concatenate(bits_np),
        sum(p.n_leaves for p in forest.ptrees), dedup=dedup))


def make_forest_fitness(forest: Forest, x_test, y_test, device="cuda"):
    """(fitness, exact_accuracy, exact_area_mm2): the reference-backend
    fitness (P, 3N+1) genes -> (P, 2) objectives of the forest's
    block-diagonal `SearchProblem`, and the exact design's accuracy and
    area the objectives are normalised by. Give the same problem to
    `repro_torch.search.run_search` for the kernel backend, checkpoints and
    artifacts."""
    from repro_torch.search import build_forest_problem, make_reference_fitness

    problem = build_forest_problem(forest, x_test, y_test, device=device)
    return (make_reference_fitness(problem), problem.exact_accuracy,
            problem.exact_area_mm2)
