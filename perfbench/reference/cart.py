"""The benchmark's frozen CART trainer and the plain tree it yields.

Gini splits on the 8-bit master grid, grown until every leaf is pure,
depth at most 64, or best first to a stated number of leaves. A split
``x8 > t8`` stores the threshold T = (t8 + 0.5) / 256, so floor(T * 2^p)
recovers the p-bit code the hardware compares against. Nodes are numbered
in the order the trainer creates them, children after their parent.

`comparator_form` lays the tree out as the bespoke circuit's comparator
array: the internal nodes in node order, the leaves in node order, and a
path matrix whose row l holds +1 / -1 for the comparators leaf l's path
needs true / false. `descend` walks rows down the exact tree: the fault
check's oracle, and the paths' mean depth the roofline counts.
"""
from __future__ import annotations

import heapq

import numpy as np

from perfbench.reference.data import quantize_u8

GRID = 256


def _best_splits(hist: np.ndarray):
    """hist (F, 256, C) class counts -> (best weighted gini, its bin) per
    feature for the split ``x8 <= t`` / ``x8 > t``."""
    cum = hist.cumsum(axis=1).astype(np.float64)
    total = cum[:, -1:, :]
    n_left = cum.sum(axis=2)
    n_right = total.sum(axis=2) - n_left
    right = total - cum
    gini_l = 1.0 - np.square(cum / np.maximum(n_left, 1e-12)[..., None]).sum(2)
    gini_r = 1.0 - np.square(right / np.maximum(n_right, 1e-12)[..., None]).sum(2)
    score = n_left * gini_l + n_right * gini_r
    score = np.where((n_left == 0) | (n_right == 0), np.inf, score)
    best = score.argmin(axis=1)
    return score[np.arange(score.shape[0]), best], best


def _histogram(x8: np.ndarray, y: np.ndarray, n_classes: int) -> np.ndarray:
    n, f = x8.shape
    flat = ((np.arange(f, dtype=np.int64) * GRID)[None, :]
            + x8.astype(np.int64)) * n_classes + y[:, None].astype(np.int64)
    return np.bincount(flat.ravel(), minlength=f * GRID * n_classes).reshape(
        f, GRID, n_classes)


def train_tree(x: np.ndarray, y: np.ndarray, n_classes: int,
               max_depth: int = 64, max_leaf_nodes: int | None = None) -> dict:
    """Node arrays of the grown tree: feature (-1 at leaves), threshold,
    left, right, leaf_class (-1 at internal nodes).

    Without ``max_leaf_nodes`` every node is split depth first until its
    leaves are pure. With it the tree grows best first, as scikit-learn's
    ``max_leaf_nodes`` grows it: the open node whose split lowers the
    weighted gini most (ties: the older node) is split next, until the tree
    has that many leaves."""
    x8 = quantize_u8(x).astype(np.int16)
    feature, threshold, left, right, leaf_class = [], [], [], [], []
    best_first = max_leaf_nodes is not None

    def new_node(idx: np.ndarray, depth: int, frontier: list) -> int:
        node = len(feature)
        ys = y[idx]
        counts = np.bincount(ys, minlength=n_classes)
        for arr, v in ((feature, -1), (threshold, 0.0), (left, -1),
                       (right, -1), (leaf_class, int(counts.argmax()))):
            arr.append(v)
        if counts.max() == idx.size or depth >= max_depth or idx.size < 2:
            return node
        score, best = _best_splits(_histogram(x8[idx], ys, n_classes))
        f = int(score.argmin())
        parent = (1.0 - np.square(counts / idx.size).sum()) * idx.size
        if not np.isfinite(score[f]) or score[f] >= parent - 1e-12:
            return node
        item = (node, idx, depth, f, int(best[f]))
        if best_first:
            heapq.heappush(frontier, (score[f] - parent, node, item))
        else:
            frontier.append(item)
        return node

    frontier: list = []
    new_node(np.arange(x.shape[0]), 0, frontier)
    n_leaves = 1
    while frontier and (not best_first or n_leaves < max_leaf_nodes):
        node, idx, depth, f, t8 = (heapq.heappop(frontier)[2] if best_first
                                   else frontier.pop())
        go_right = x8[idx, f] > t8
        feature[node], leaf_class[node] = f, -1
        threshold[node] = (t8 + 0.5) / GRID
        left[node] = new_node(idx[~go_right], depth + 1, frontier)
        right[node] = new_node(idx[go_right], depth + 1, frontier)
        n_leaves += 1
    return {"feature": np.asarray(feature, np.int32),
            "threshold": np.asarray(threshold, np.float32),
            "left": np.asarray(left, np.int32),
            "right": np.asarray(right, np.int32),
            "leaf_class": np.asarray(leaf_class, np.int32)}


def comparator_form(tree: dict) -> dict:
    """feature, threshold (N,), path (L, N) int8, path_len, n_neg,
    leaf_class (L,), and comparator (n_nodes,): each node's comparator
    index (-1 at leaves)."""
    feat = tree["feature"]
    internal = np.flatnonzero(feat >= 0)
    leaves = np.flatnonzero(feat < 0)
    comparator = np.full(feat.shape[0], -1, np.int64)
    comparator[internal] = np.arange(internal.size)
    row = np.full(feat.shape[0], -1, np.int64)
    row[leaves] = np.arange(leaves.size)
    path = np.zeros((leaves.size, max(internal.size, 1)), np.int8)
    stack = [(0, ())]
    while stack:
        node, prefix = stack.pop()
        if feat[node] < 0:
            for c, d in prefix:
                path[row[node], c] = d
            continue
        c = comparator[node]
        stack.append((int(tree["left"][node]), prefix + ((c, -1),)))
        stack.append((int(tree["right"][node]), prefix + ((c, 1),)))
    return {"feature": feat[internal].astype(np.int32),
            "threshold": tree["threshold"][internal].astype(np.float32),
            "path": path,
            "path_len": (path != 0).sum(axis=1).astype(np.int32),
            "n_neg": (path == -1).sum(axis=1).astype(np.int32),
            "leaf_class": tree["leaf_class"][leaves].astype(np.int32),
            "comparator": comparator}


def descend(tree: dict, x8: np.ndarray):
    """(classes (B,), depth (B,)) of rows ``x8`` (B, F) codes descending the
    exact tree: node n goes right where ``x8 > floor(T[n] * 256)``."""
    feat = tree["feature"]
    t_int = np.floor(tree["threshold"].astype(np.float64) * GRID).astype(
        np.int64)
    x8 = np.asarray(x8, np.int64)
    rows = np.arange(x8.shape[0])
    node = np.zeros(x8.shape[0], np.int64)
    depth = np.zeros(x8.shape[0], np.int64)
    while True:
        active = feat[node] >= 0
        if not active.any():
            break
        f = np.maximum(feat[node], 0)
        go_right = x8[rows, f] > t_int[node]
        nxt = np.where(go_right, tree["right"][node], tree["left"][node])
        node = np.where(active, nxt, node)
        depth += active
    return tree["leaf_class"][node].astype(np.int32), depth
