"""The plain reference of the forest cells: bagged CART trees voting, and
the two objectives of a forest chromosome, in numpy and plain PyTorch.

The forest. Each tree is a bespoke approximate tree (arXiv:2203.08011)
grown on a bag, after Breiman, "Random Forests", Machine Learning 45
(2001): the training rows drawn with replacement, n of n, and a random
share of the features. One ``np.random.default_rng(bag_seed)`` draws, tree
by tree, ``integers(0, n, n)`` rows and then ``permutation(F)[:int(F *
share)]`` features; the other features are set to 0, so no split can use
them, and the tree is `cart.train_tree` on that bag.

The vote stage. Each tree votes one-hot for the class of the leaf its row
reaches. Per class an exact adder counts the trees' votes with a popcount
adder tree; the approximate adder (the forest's vote gene) keeps one bit
a class, the OR of its votes, so the count is capped at 1. A first-max
chain then picks the class: C - 1 unsigned greater-than compares of a
class's count with the best so far, each with a mux of the count and of
the class index. `vote_units` counts the stage's gates built on free
input wires, constants folded and identical gates shared, as the
repository's netlist builds it, and prices them with `area`'s gates.

Objectives (both minimised, float32): the exact design's test accuracy
minus the chromosome's, and its area over the exact design's. Genes decode
as `search.TreeObjectives.design` decodes them, over the trees'
comparators in tree order, and the trailing vote gene selects the
approximate adder where ``clamp(floor(2 g), 0, 1)`` is 1. The area in whole
quanta is the comparators' table entries, N node and L leaf overheads and
the vote stage of the decoded adder; the exact design has every
comparator at 8 bits, margin 0, truncation 0, and the exact adder.

Departures from the published description: Breiman draws a feature
subset at each split, here one subset a tree (the repository's
`train_forest`); trees are grown until their leaves are pure (depth at
most 64) on the 8-bit master grid; a tie between classes goes to the
lowest class index; the approximate adder is the repository's own vote
stage, not Breiman's.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import area, cart
from perfbench.reference import search as ref


def train_forest(x: np.ndarray, y: np.ndarray, n_classes: int, n_trees: int,
                 bag_seed: int, feature_fraction: float,
                 max_depth: int = 64) -> list[dict]:
    """The node arrays of each bagged tree, in the order they were drawn."""
    rng = np.random.default_rng(bag_seed)
    n, f = x.shape
    trees = []
    for _ in range(n_trees):
        rows = rng.integers(0, n, n)
        feats = rng.permutation(f)[:max(1, int(f * feature_fraction))]
        bag = np.zeros_like(x)
        bag[:, feats] = x[rows][:, feats]
        trees.append(cart.train_tree(bag, y[rows], n_classes,
                                     max_depth=max_depth))
    return trees


# -- the vote stage's gates ----------------------------------------------------
NOT, AND, OR, XOR = "not", "and", "or", "xor"
ZERO, ONE = 0, 1


class _Gates:
    """Wires of 2-input gates: constants folded, identical gates shared."""

    def __init__(self):
        self.gates: dict[tuple, int] = {}
        self.kind: dict[int, tuple] = {}
        self.wires = 2                      # 0 and 1 are the constants

    def free(self) -> int:
        self.wires += 1
        return self.wires - 1

    def _gate(self, op: str, a: int, b: int = -1) -> int:
        key = (op, a, b)
        if key not in self.gates:
            self.gates[key] = self.free()
            self.kind[self.gates[key]] = key
        return self.gates[key]

    def not_(self, x: int) -> int:
        if x in (ZERO, ONE):
            return ONE - x
        if self.kind.get(x, ("",))[0] == NOT:
            return self.kind[x][1]
        return self._gate(NOT, x)

    def _complements(self, x: int, y: int) -> bool:
        return self.kind.get(x) == (NOT, y, -1) or self.kind.get(y) == (
            NOT, x, -1)

    def and_(self, x: int, y: int) -> int:
        if x == y or y == ONE:
            return x
        if x == ONE:
            return y
        if ZERO in (x, y) or self._complements(x, y):
            return ZERO
        return self._gate(AND, min(x, y), max(x, y))

    def or_(self, x: int, y: int) -> int:
        if x == y or y == ZERO:
            return x
        if x == ZERO:
            return y
        if ONE in (x, y) or self._complements(x, y):
            return ONE
        return self._gate(OR, min(x, y), max(x, y))

    def xor_(self, x: int, y: int) -> int:
        if x == y:
            return ZERO
        if ZERO in (x, y):
            return x + y
        if ONE in (x, y):
            return self.not_(x + y - ONE)
        if self._complements(x, y):
            return ONE
        return self._gate(XOR, min(x, y), max(x, y))

    @staticmethod
    def pairwise(items: list, join):
        """``items`` joined in pairs, level by level, until one is left."""
        while len(items) > 1:
            items = [join(items[i], items[i + 1])
                     for i in range(0, len(items) - 1, 2)] + items[
                         len(items) - len(items) % 2:]
        return items[0]

    @staticmethod
    def _padded(a: list, b: list):
        n = max(len(a), len(b))
        return a + [ZERO] * (n - len(a)), b + [ZERO] * (n - len(b))

    def add(self, a: list, b: list) -> list:
        """Ripple-carry sum of two LSB-first vectors, the carry out kept."""
        out, carry = [], ZERO
        for x, y in zip(*self._padded(a, b)):
            s1 = self.xor_(x, y)
            out.append(self.xor_(s1, carry))
            carry = self.or_(self.and_(x, y), self.and_(s1, carry))
        return out + [carry]

    def greater(self, a: list, b: list) -> int:
        """Unsigned a > b, LSB to MSB."""
        g = ZERO
        for x, y in zip(*self._padded(a, b)):
            above = self.and_(x, self.not_(y))
            same = self.not_(self.xor_(x, y))
            g = self.or_(above, self.and_(same, g))
        return g

    def mux(self, sel: int, a: list, b: list) -> list:
        a, b = self._padded(a, b)
        ns = self.not_(sel)
        return [self.or_(self.and_(sel, x), self.and_(ns, y))
                for x, y in zip(a, b)]

    def units(self) -> int:
        price = {NOT: area.NOT1, AND: area.AND2, OR: area.OR2,
                 XOR: area.XOR2}
        return sum(price[op] for op, _, _ in self.gates)


def class_bits(n_classes: int) -> int:
    return max(1, int(np.ceil(np.log2(max(n_classes, 2)))))


def vote_units(n_trees: int, n_classes: int, approx: bool) -> int:
    """The vote stage's area in whole quanta (0 for one tree, which votes
    one-hot and needs no adder)."""
    if n_trees <= 1:
        return 0
    g = _Gates()
    votes = [[g.free() for _ in range(n_classes)] for _ in range(n_trees)]
    if approx:
        counts = [[g.pairwise([v[c] for v in votes], g.or_)]
                  for c in range(n_classes)]
    else:
        counts = [g.pairwise([[v[c]] for v in votes], g.add)
                  for c in range(n_classes)]
    width = class_bits(n_classes)

    def index(c):
        return [ONE if (c >> i) & 1 else ZERO for i in range(width)]

    best, best_index = counts[0], index(0)
    for c in range(1, n_classes):
        sel = g.greater(counts[c], best)
        best = g.mux(sel, counts[c], best)
        best_index = g.mux(sel, index(c), best_index)
    return g.units()


# -- the objectives ------------------------------------------------------------
class _Tree:
    """One tree's node arrays on the device, its comparators numbered in
    the forest's chromosome."""

    def __init__(self, tree: dict, offset: int, t):
        form = cart.comparator_form(tree)
        feat = tree["feature"]
        self.feature = t(np.maximum(feat, 0))
        self.comp = t(np.maximum(form["comparator"], 0) + offset)
        self.internal = t(feat >= 0, torch.bool)
        self.left, self.right = t(tree["left"]), t(tree["right"])
        self.leaf_class = t(tree["leaf_class"])
        self.threshold = form["threshold"]
        self.n_leaves = form["leaf_class"].size


class ForestObjectives:
    """(P, 3N+1) genes -> (P, 2) objectives of a bagged forest."""

    design = ref.TreeObjectives.design

    def __init__(self, trees: list[dict], x8, y, n_classes: int, device):
        self.dev = dev = torch.device(device)

        def t(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        self.trees, offset = [], 0
        for tree in trees:
            self.trees.append(_Tree(tree, offset, t))
            offset += self.trees[-1].threshold.size
        self.n = offset
        self.n_classes = n_classes
        threshold = np.concatenate([tr.threshold for tr in self.trees])
        self.threshold = t(threshold, torch.float32)
        self.x8, self.y = t(x8), t(y)
        table = area.comparator_table()
        self.table = t(table)
        self.overhead = (self.n * area.NODE
                         + sum(tr.n_leaves for tr in self.trees) * area.LEAF)
        self.vote_exact = vote_units(len(trees), n_classes, approx=False)
        self.vote_approx = vote_units(len(trees), n_classes, approx=True)
        t8 = np.floor(threshold.astype(np.float64) * 256).astype(int)
        self.exact_units = (int(table[8, t8].sum()) + self.overhead
                            + self.vote_exact)
        rows = self.x8.shape[0]
        self.inv_rows = torch.tensor(float(np.float32(1) / np.float32(rows)),
                                     dtype=torch.float32, device=dev)
        exact = np.zeros((1, 3 * self.n + 1), np.float32)
        exact[0, 0:-1:3], exact[0, 1:-1:3] = 0.999, 0.5
        exact = t(exact, torch.float32)
        self.exact_accuracy = self._accuracy(*self.design(exact),
                                             self._approx(exact))[0]

    @staticmethod
    def _approx(genes: torch.Tensor) -> torch.Tensor:
        """(P,) bool: the vote gene selects the approximate adder."""
        vote = genes[:, -1].to(torch.float32)
        return torch.clamp(torch.floor(vote * 2), 0, 1) == 1

    def _classes(self, tree: _Tree, bits, thr) -> torch.Tensor:
        """(P, B) class of the leaf each row reaches in ``tree``."""
        p, b = bits.shape[0], self.x8.shape[0]
        node = torch.zeros((p, b), dtype=torch.int64, device=self.dev)
        rows = torch.arange(b, device=self.dev).expand(p, b)
        for _ in range(tree.left.shape[0]):
            active = tree.internal[node]
            if not bool(active.any()):
                break
            comp = tree.comp[node]
            x = self.x8[rows, tree.feature[node]]
            shift = 8 - torch.gather(bits, 1, comp)
            right = (x >> shift) > torch.gather(thr, 1, comp)
            nxt = torch.where(right, tree.right[node], tree.left[node])
            node = torch.where(active, nxt, node)
        return tree.leaf_class[node]

    def _accuracy(self, bits, thr, approx) -> torch.Tensor:
        classes = torch.arange(self.n_classes, device=self.dev)
        votes = torch.zeros((bits.shape[0], self.x8.shape[0], self.n_classes),
                            dtype=torch.int64, device=self.dev)
        for tree in self.trees:
            votes += self._classes(tree, bits, thr)[..., None] == classes
        votes = torch.where(approx[:, None, None], votes.clamp(max=1), votes)
        top = votes.amax(-1, keepdim=True)
        first = torch.where(votes == top, classes, self.n_classes).amin(-1)
        correct = (first == self.y).sum(1)
        return correct.to(torch.float32) * self.inv_rows

    def __call__(self, genes: torch.Tensor) -> torch.Tensor:
        bits, thr = self.design(genes)
        approx = self._approx(genes)
        acc = self._accuracy(bits, thr, approx)
        units = (self.table[bits, thr].sum(1) + self.overhead
                 + torch.where(approx, self.vote_approx, self.vote_exact))
        area_ratio = units.to(torch.float32) / float(self.exact_units)
        return torch.stack([self.exact_accuracy - acc, area_ratio], dim=1)

