"""Flattened decision trees in the parallel comparator-array form.

The bespoke circuit evaluates every comparator at once and a leaf-decode
stage selects the class. The same dataflow runs on the GPU:

  decisions D[b, n] = (x_int[b, feat[n]] > t_int[n])          (comparator array)
  score[b, l]      = D[b] . P[l]                              (path product)
  leaf fires       iff score[b, l] == path_len[l] - n_neg[l]  (leaf decode)

P[l, n] = +1 if leaf l's path requires decision n true (go right), -1 if it
requires it false, 0 if node n is not on the path. The layout is built on
the host in numpy, as in `repro.core.tree`; `predict_descent_quantized` is
the independent sequential oracle, and `predict_quantized` the matmul-form
one on torch tensors (the JAX package's `ptree_to_jnp` has no counterpart:
its callers pass a dict of tensors).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.train import TreeArrays


@dataclasses.dataclass
class ParallelTree:
    """Comparator-array form. N comparators (internal nodes), L leaves."""

    feature: np.ndarray     # int32[N]  feature index per comparator
    threshold: np.ndarray   # float32[N] trained float threshold in (0,1)
    path: np.ndarray        # int8[L, N] in {-1, 0, +1}
    path_len: np.ndarray    # int32[L]  number of nonzeros per row
    n_neg: np.ndarray       # int32[L]  number of -1 per row
    leaf_class: np.ndarray  # int32[L]
    n_classes: int

    @property
    def n_comparators(self) -> int:
        return int(self.feature.shape[0])

    @property
    def n_leaves(self) -> int:
        return int(self.leaf_class.shape[0])


def to_parallel(tree: TreeArrays) -> ParallelTree:
    """Flatten a TreeArrays into the comparator-array + path-matrix form."""
    internal = np.flatnonzero(tree.feature >= 0)
    leaves = np.flatnonzero(tree.feature < 0)
    comp_of_node = {int(n): i for i, n in enumerate(internal)}
    n_comp, n_leaf = len(internal), len(leaves)

    path = np.zeros((n_leaf, max(n_comp, 1)), dtype=np.int8)
    # DFS carrying the (comparator, direction) prefix
    stack = [(0, [])]
    leaf_rows = {}
    while stack:
        node, prefix = stack.pop()
        if tree.feature[node] < 0:
            leaf_rows[node] = prefix
            continue
        c = comp_of_node[node]
        stack.append((int(tree.left[node]), prefix + [(c, -1)]))
        stack.append((int(tree.right[node]), prefix + [(c, +1)]))
    for row, node in enumerate(leaves):
        for c, d in leaf_rows[int(node)]:
            path[row, c] = d

    pl = (path != 0).sum(axis=1).astype(np.int32)
    nn = (path == -1).sum(axis=1).astype(np.int32)
    return ParallelTree(
        feature=tree.feature[internal].astype(np.int32),
        threshold=tree.threshold[internal].astype(np.float32),
        path=path,
        path_len=pl,
        n_neg=nn,
        leaf_class=tree.leaf_class[leaves].astype(np.int32),
        n_classes=tree.n_classes,
    )


def concatenate_ptrees(ptrees) -> dict:
    """Concatenated comparator/leaf arrays + block-diagonal super-tree path.

    The comparator axis concatenates every tree's comparators, the leaf axis
    every tree's leaves, and `path` is block-diagonal so each leaf row only
    sees its own tree's comparators. Returns numpy arrays.
    """
    n_total = sum(pt.n_comparators for pt in ptrees)
    l_total = sum(pt.n_leaves for pt in ptrees)
    path = np.zeros((l_total, n_total), np.int8)
    leaf_tree = np.concatenate([
        np.full(pt.n_leaves, k, np.int32) for k, pt in enumerate(ptrees)])
    n_off = l_off = 0
    for pt in ptrees:
        path[l_off:l_off + pt.n_leaves, n_off:n_off + pt.n_comparators] = pt.path
        n_off += pt.n_comparators
        l_off += pt.n_leaves
    return {
        "feature": np.concatenate([pt.feature for pt in ptrees]).astype(np.int32),
        "threshold": np.concatenate(
            [pt.threshold for pt in ptrees]).astype(np.float32),
        "path": path,
        "path_len": np.concatenate(
            [pt.path_len for pt in ptrees]).astype(np.int32),
        "n_neg": np.concatenate([pt.n_neg for pt in ptrees]).astype(np.int32),
        "leaf_class": np.concatenate(
            [pt.leaf_class for pt in ptrees]).astype(np.int32),
        "leaf_tree": leaf_tree,
    }


def decisions_quantized(x8: torch.Tensor, feature: torch.Tensor,
                        threshold: torch.Tensor, bits: torch.Tensor,
                        margin: torch.Tensor) -> torch.Tensor:
    """Comparator array under the dual approximation.

    x8 (B, F) integer master codes; feature (N,), threshold (N,) float,
    bits (N,) in [2, 8], margin (N,) in [-5, 5]. Returns bool (B, N).
    """
    t_int = quant.threshold_to_int(threshold, bits)
    t_sub = quant.substitute(t_int, margin, bits)
    x_p = quant.inputs_at_precision(x8[:, feature.long()], bits)
    return x_p > t_sub[None, :]


def leaves_from_decisions(decisions: torch.Tensor, path: torch.Tensor,
                          path_len: torch.Tensor) -> torch.Tensor:
    """decisions bool (B, N) -> leaf index (B,) via the path matmul: the
    first leaf whose score (+1 hits minus -1 hits) reaches its target
    path_len - #(-1), the first maximum as `jnp.argmax` takes it."""
    score = decisions.to(torch.float32) @ path.to(torch.float32).T  # (B, L)
    target = (path_len - (path == -1).sum(dim=1)).to(torch.float32)
    return torch.argmax(score - target[None, :], dim=1)


def predict_quantized(x8: torch.Tensor, ptree_arrays: dict,
                      bits: torch.Tensor, margin: torch.Tensor) -> torch.Tensor:
    """The full matmul-form pipeline; ``ptree_arrays`` a dict of tensors
    (feature, threshold, path, path_len, leaf_class)."""
    d = decisions_quantized(x8, ptree_arrays["feature"],
                            ptree_arrays["threshold"], bits, margin)
    leaf = leaves_from_decisions(d, ptree_arrays["path"],
                                 ptree_arrays["path_len"])
    return ptree_arrays["leaf_class"][leaf]


def predict_descent_quantized(x8, tree: TreeArrays, bits_full, margin_full):
    """Independent oracle: sequential descent with quantized comparators.

    bits_full/margin_full are per-*node* arrays aligned with tree arrays
    (entries at leaf positions ignored). Cross-checks the parallel form.
    """
    x8 = np.asarray(x8)
    n = x8.shape[0]
    node = np.zeros(n, dtype=np.int64)
    bits_full = np.asarray(bits_full)
    margin_full = np.asarray(margin_full)
    for _ in range(tree.n_nodes):
        f = tree.feature[node]
        active = f >= 0
        if not active.any():
            break
        p = bits_full[node]
        t_int = np.floor(tree.threshold[node] * (2.0 ** p)).astype(np.int64)
        t_int = np.clip(t_int, 0, (1 << p) - 1)
        t_sub = np.clip(t_int + margin_full[node], 0, (1 << p) - 1)
        xv = x8[np.arange(n), np.maximum(f, 0)] >> (8 - p)
        go_right = xv > t_sub
        nxt = np.where(go_right, tree.right[node], tree.left[node])
        node = np.where(active, nxt, node)
    return tree.leaf_class[node].astype(np.int32)


def random_tree(rng: np.random.Generator, n_comparators: int,
                n_features: int, n_classes: int) -> TreeArrays:
    """A random tree of exactly ``n_comparators`` internal nodes, in
    preorder as `core.train.train_tree` lays trees out: each node splits its
    remaining internal nodes uniformly between its children. It exercises
    the kernels past any dataset's width (a tree of 4096 comparators)."""
    feature, threshold, left, right, leaf_class = [], [], [], [], []
    stack = [(-1, 0, n_comparators)]   # (parent, 0 left / 1 right, size)
    while stack:
        parent, side, size = stack.pop()
        node = len(feature)
        if parent >= 0:
            (left if side == 0 else right)[parent] = node
        left.append(-1)
        right.append(-1)
        if size == 0:
            feature.append(-1)
            threshold.append(0.0)
            leaf_class.append(int(rng.integers(0, n_classes)))
            continue
        feature.append(int(rng.integers(0, n_features)))
        threshold.append(float(rng.uniform(0.05, 0.95)))
        leaf_class.append(-1)
        n_left = int(rng.integers(0, size))
        stack.append((node, 1, size - 1 - n_left))
        stack.append((node, 0, n_left))
    return TreeArrays(
        feature=np.asarray(feature, np.int32),
        threshold=np.asarray(threshold, np.float32),
        left=np.asarray(left, np.int32), right=np.asarray(right, np.int32),
        leaf_class=np.asarray(leaf_class, np.int32), n_classes=n_classes)
