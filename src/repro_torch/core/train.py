"""CART Decision-Tree training (gini, expand-until-pure), pure numpy.

A copy of `repro.core.train` for the PyTorch port (training runs on the
host in both packages); the parity tests require identical trees.

The paper trains with scikit-learn, nodes "expanded until all leaves are pure"
(max number of leaves). We reimplement CART with histogram-based splitting on
the 8-bit master grid: inputs are normalized to [0,1] and the bespoke hardware
evaluates 8-bit (or lower) comparators anyway, so candidate thresholds live on
the 2^8 grid by construction. Within that grid the search is exact.

Thresholds are stored as floats T = (t8 + 0.5) / 256 so that the master 8-bit
integer code is recovered exactly by floor(T * 256) = t8 (see core.quant).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.datasets.synthetic import quantize_u8

MASTER_BITS = 8
GRID = 1 << MASTER_BITS


@dataclasses.dataclass
class TreeArrays:
    """Flattened decision tree.

    Internal node semantics: go RIGHT iff x_int(feature) > threshold_int,
    i.e. x > threshold in the reals. Node 0 is the root.
    """

    feature: np.ndarray      # int32[n_nodes], -1 for leaves
    threshold: np.ndarray    # float32[n_nodes], 0 for leaves; in (0,1)
    left: np.ndarray         # int32[n_nodes], -1 for leaves
    right: np.ndarray        # int32[n_nodes], -1 for leaves
    leaf_class: np.ndarray   # int32[n_nodes], -1 for internal
    n_classes: int

    @property
    def n_nodes(self) -> int:
        return int(self.feature.shape[0])

    @property
    def is_leaf(self) -> np.ndarray:
        return self.feature < 0

    @property
    def n_comparators(self) -> int:
        return int((self.feature >= 0).sum())

    @property
    def n_leaves(self) -> int:
        return int((self.feature < 0).sum())

    @property
    def depth(self) -> int:
        depth = np.zeros(self.n_nodes, dtype=np.int32)
        order = range(self.n_nodes)
        for i in order:  # children always appear after parents
            if self.feature[i] >= 0:
                depth[self.left[i]] = depth[i] + 1
                depth[self.right[i]] = depth[i] + 1
        return int(depth.max()) if self.n_nodes else 0


def _gini_split_scores(hist: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """hist: (F, B, C) class counts per (feature, bin).

    Returns (best_score[F], best_bin[F]) where score is the weighted gini of
    children for the split ``x8 <= t`` / ``x8 > t`` at each bin t, minimized.
    Invalid splits (empty side) score +inf.
    """
    cum = hist.cumsum(axis=1).astype(np.float64)            # (F, B, C) left counts
    total = cum[:, -1:, :]                                   # (F, 1, C)
    n_left = cum.sum(axis=2)                                 # (F, B)
    n_total = total.sum(axis=2)                              # (F, 1)
    n_right = n_total - n_left
    right = total - cum
    nl = np.maximum(n_left, 1e-12)
    nr = np.maximum(n_right, 1e-12)
    gini_l = 1.0 - np.square(cum / nl[..., None]).sum(axis=2)
    gini_r = 1.0 - np.square(right / nr[..., None]).sum(axis=2)
    score = n_left * gini_l + n_right * gini_r               # (F, B)
    score = np.where((n_left == 0) | (n_right == 0), np.inf, score)
    best_bin = score.argmin(axis=1)
    best_score = score[np.arange(score.shape[0]), best_bin]
    return best_score, best_bin


def _node_histogram(x8: np.ndarray, y: np.ndarray, n_classes: int) -> np.ndarray:
    """Class-count histogram, shape (F, GRID, C), via one flat bincount."""
    n, f = x8.shape
    base = (np.arange(f, dtype=np.int64) * GRID)[None, :]     # (1, F)
    flat = (base + x8.astype(np.int64)) * n_classes + y[:, None].astype(np.int64)
    counts = np.bincount(flat.ravel(), minlength=f * GRID * n_classes)
    return counts.reshape(f, GRID, n_classes)


def train_tree(
    x: np.ndarray,
    y: np.ndarray,
    n_classes: int,
    max_depth: int = 64,
    min_samples_leaf: int = 1,
) -> TreeArrays:
    """Grow a CART tree until leaves are pure (or unsplittable on the grid)."""
    x8 = quantize_u8(x, MASTER_BITS).astype(np.int16)
    n = x.shape[0]

    feature, threshold, left, right, leaf_cls = [], [], [], [], []

    def new_node() -> int:
        feature.append(-1)
        threshold.append(0.0)
        left.append(-1)
        right.append(-1)
        leaf_cls.append(-1)
        return len(feature) - 1

    # stack of (node_id, sample_indices, depth); children get ids > parent
    root = new_node()
    stack = [(root, np.arange(n), 0)]
    while stack:
        node, idx, depth = stack.pop()
        ys = y[idx]
        counts = np.bincount(ys, minlength=n_classes)
        majority = int(counts.argmax())
        pure = counts.max() == idx.size
        if pure or depth >= max_depth or idx.size < 2 * min_samples_leaf:
            leaf_cls[node] = majority
            continue
        hist = _node_histogram(x8[idx], ys, n_classes)
        best_score, best_bin = _gini_split_scores(hist)
        f = int(best_score.argmin())
        if not np.isfinite(best_score[f]):
            leaf_cls[node] = majority           # all features constant on grid
            continue
        t8 = int(best_bin[f])
        go_right = x8[idx, f] > t8
        idx_l, idx_r = idx[~go_right], idx[go_right]
        if idx_l.size < min_samples_leaf or idx_r.size < min_samples_leaf:
            leaf_cls[node] = majority
            continue
        # parent gini must strictly improve, else stop (ties on the grid)
        parent_gini = (1.0 - np.square(counts / idx.size).sum()) * idx.size
        if best_score[f] >= parent_gini - 1e-12:
            leaf_cls[node] = majority
            continue
        feature[node] = f
        threshold[node] = (t8 + 0.5) / GRID
        l_id, r_id = new_node(), new_node()
        left[node], right[node] = l_id, r_id
        stack.append((l_id, idx_l, depth + 1))
        stack.append((r_id, idx_r, depth + 1))

    return TreeArrays(
        feature=np.asarray(feature, dtype=np.int32),
        threshold=np.asarray(threshold, dtype=np.float32),
        left=np.asarray(left, dtype=np.int32),
        right=np.asarray(right, dtype=np.int32),
        leaf_class=np.asarray(leaf_cls, dtype=np.int32),
        n_classes=n_classes,
    )


def predict_numpy(tree: TreeArrays, x: np.ndarray) -> np.ndarray:
    """Reference traversal prediction (float thresholds), vectorized descent."""
    node = np.zeros(x.shape[0], dtype=np.int64)
    for _ in range(tree.n_nodes):  # upper bound on depth
        f = tree.feature[node]
        done = f < 0
        if done.all():
            break
        fx = x[np.arange(x.shape[0]), np.maximum(f, 0)]
        go_right = fx > tree.threshold[node]
        nxt = np.where(go_right, tree.right[node], tree.left[node])
        node = np.where(done, node, nxt)
    return tree.leaf_class[node].astype(np.int32)
