"""The plain reference of the search cells: the two objectives of a
chromosome and NSGA-II's generations, in plain PyTorch.

Objectives (both minimised, float32): the exact design's test accuracy
minus the chromosome's, and its area over the exact design's, both areas
in whole quanta. The tree's accuracy is its correct count times the
float32 reciprocal of the row count, the MLP's a float32 division: the
rounding each family states.

Tree chromosome: three genes per comparator (precision p in [2, 8], margin
m in [-5, 5], truncation k in [0, 2]) and a vote gene (inert for one
tree). A comparator compares ``x8 >> (8 - (p - k))`` against
``clip(floor(T 2^p) + m, 0, 2^p - 1) >> k``; the rows descend the tree
(`cart.descend`'s walk, on the device) and the leaf's class is the vote.

NSGA-II (Deb et al. 2002, as this repository states it): binary
tournament on (rank, crowding), simulated binary crossover (eta 20, p
0.9), polynomial mutation (eta 20, p = 1 / genes), the (mu + lambda)
pool's non-dominated fronts peeled one by one, crowding within each front
on a float32 key ``rank * 1e9 + value`` (so past front 0 the key ties
and a front keeps its pool order), and survivors by (rank, -crowding).
Each generation draws, from the search's generator, in this order: two
tournament index vectors, the crossover uniforms, its do and swap
uniforms, the mutation uniforms and its mask uniforms.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import area, mlp

BIG = 1e9
ETA_C = ETA_M = 20.0
P_CROSS = 0.9


class TreeObjectives:
    """(P, 3N+1) genes -> (P, 2) objectives of one trained tree."""

    def __init__(self, tree: dict, form: dict, x8, y, device):
        self.dev = dev = torch.device(device)
        feat = tree["feature"]
        self.n = n = form["feature"].shape[0]

        def t(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        self.node_feature = t(np.maximum(feat, 0))
        self.node_comp = t(np.maximum(form["comparator"], 0))
        self.internal = t(feat >= 0, torch.bool)
        self.left, self.right = t(tree["left"]), t(tree["right"])
        self.leaf_class = t(tree["leaf_class"])
        self.threshold = t(form["threshold"], torch.float32)
        self.x8, self.y = t(x8), t(y)
        table = area.comparator_table()
        self.table = t(table)
        self.overhead = n * area.NODE + len(form["leaf_class"]) * area.LEAF
        t8 = np.floor(form["threshold"].astype(np.float64) * 256).astype(int)
        self.exact_units = int(table[8, t8].sum()) + self.overhead
        rows = self.x8.shape[0]
        self.inv_rows = torch.tensor(float(np.float32(1) / np.float32(rows)),
                                     dtype=torch.float32, device=dev)
        exact = np.zeros((1, 3 * n + 1), np.float32)
        exact[0, 0:-1:3], exact[0, 1:-1:3] = 0.999, 0.5
        bits, thr = self.design(t(exact, torch.float32))
        self.exact_accuracy = self._accuracy(bits, thr)[0]

    def design(self, genes: torch.Tensor):
        """(effective bits, effective thresholds) per comparator, int64."""
        g = genes.to(torch.float32)
        gp, gm, gt = g[:, 0:-1:3], g[:, 1:-1:3], g[:, 2:-1:3]
        bits = (2 + torch.clamp(torch.floor(gp * 7), 0, 6)).long()
        margin = (-5 + torch.clamp(torch.floor(gm * 11), 0, 10)).long()
        trunc = torch.clamp(torch.floor(gt * 3), 0, 2).long()
        top = (1 << bits) - 1
        t_int = torch.floor(self.threshold * torch.exp2(bits.float())).long()
        t_sub = torch.minimum(torch.clamp(torch.minimum(t_int, top) + margin,
                                          min=0), top)
        return bits - trunc, t_sub >> trunc

    def _correct(self, bits, thr) -> torch.Tensor:
        p, b = bits.shape[0], self.x8.shape[0]
        node = torch.zeros((p, b), dtype=torch.int64, device=self.dev)
        rows = torch.arange(b, device=self.dev).expand(p, b)
        for _ in range(self.left.shape[0]):
            active = self.internal[node]
            if not bool(active.any()):
                break
            comp = self.node_comp[node]
            x = self.x8[rows, self.node_feature[node]]
            shift = 8 - torch.gather(bits, 1, comp)
            right = (x >> shift) > torch.gather(thr, 1, comp)
            nxt = torch.where(right, self.right[node], self.left[node])
            node = torch.where(active, nxt, node)
        return (self.leaf_class[node] == self.y).sum(1)

    def _accuracy(self, bits, thr):
        return self._correct(bits, thr).to(torch.float32) * self.inv_rows

    def __call__(self, genes: torch.Tensor) -> torch.Tensor:
        bits, thr = self.design(genes)
        acc = self._accuracy(bits, thr)
        units = self.table[bits, thr].sum(1) + self.overhead
        area_ratio = units.to(torch.float32) / float(self.exact_units)
        return torch.stack([self.exact_accuracy - acc, area_ratio], dim=1)


class MLPObjectives:
    """(P, 2(H+C)) genes -> (P, 2) objectives of one set of master codes."""

    def __init__(self, w1, w2, x8, y, device):
        self.dev = dev = torch.device(device)
        self.shift = mlp.shift_for(*w1.shape)
        eff1, eff2, cost1, cost2 = mlp.decode_tables(w1, w2, self.shift)

        def t(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        self.eff1 = t(eff1, torch.float64)
        self.eff2 = t(eff2, torch.float64)
        self.cost1, self.cost2 = t(cost1), t(cost2)
        self.x8, self.y = t(x8, torch.float64), t(y)
        self.h, self.c = w2.shape
        self.exact_units = int(cost1[mlp.EXACT_ROW].sum()
                               + cost2[mlp.EXACT_ROW].sum())
        exact = np.zeros((1, 2 * (self.h + self.c)), np.float32)
        exact[0, 0::2] = 0.999
        correct, _ = self._correct_units(t(exact, torch.float32))
        self.exact_accuracy = self._accuracy(correct)[0]

    def _correct_units(self, genes):
        g = genes.to(torch.float32)
        bits = torch.clamp(torch.floor(g[:, 0::2] * 3), 0, 2)
        margin = torch.clamp(torch.floor(g[:, 1::2] * 6), 0, 5)
        rows = (bits * 6 + margin).long()
        kh, ko = rows[:, :self.h], rows[:, self.h:]
        hid = torch.arange(self.h, device=self.dev)
        out = torch.arange(self.c, device=self.dev)
        p, f = genes.shape[0], self.x8.shape[1]
        w1 = self.eff1[kh, :, hid]                          # (P, H, F)
        w1 = w1.permute(2, 0, 1).reshape(f, p * self.h)
        w2 = self.eff2[ko[:, None, :], hid[None, :, None], out[None, None, :]]
        h = torch.clamp(self.x8 @ w1, min=0).reshape(-1, p, self.h)
        h = torch.floor(h / 2 ** self.shift)                  # exact: integers
        s = torch.einsum("bph,phc->pbc", h, w2)
        correct = (torch.argmax(s, dim=-1) == self.y).sum(1)
        units = self.cost1[kh, hid].sum(1) + self.cost2[ko, out].sum(1)
        return correct, units

    def _accuracy(self, correct):
        return correct.to(torch.float32) / torch.full(
            (), float(self.y.shape[0]), dtype=torch.float32, device=self.dev)

    def __call__(self, genes: torch.Tensor) -> torch.Tensor:
        correct, units = self._correct_units(genes)
        area_ratio = units.to(torch.float32) / float(self.exact_units)
        return torch.stack([self.exact_accuracy - self._accuracy(correct),
                            area_ratio], dim=1)


def fronts(objs: torch.Tensor) -> torch.Tensor:
    """int64 front index of each row of (P, 2) minimised objectives, by
    peeling: front r holds the rows no remaining row dominates."""
    le = (objs[:, None, :] <= objs[None, :, :]).all(-1)
    lt = (objs[:, None, :] < objs[None, :, :]).any(-1)
    dominates = (le & lt).to(torch.int32)                 # [i, j]: i over j
    rank = torch.full((objs.shape[0],), -1, dtype=torch.int64,
                      device=objs.device)
    left = torch.ones_like(rank, dtype=torch.bool)
    for r in range(objs.shape[0]):
        beaten = (left.to(torch.int32)[:, None] * dominates).sum(0) > 0
        front = left & ~beaten
        rank[front] = r
        left &= ~front
        if not bool(left.any()):
            break
    return rank


def crowding(objs: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """float32 crowding distance within each front (ends: 1e9)."""
    p = objs.shape[0]
    total = None
    for k in range(objs.shape[1]):
        v = objs[:, k]
        order = torch.argsort(rank.to(torch.float32) * BIG + v, stable=True)
        vs, rs = v[order], rank[order]
        lo = torch.full((p,), float("inf"), device=v.device).scatter_reduce(
            0, rs, vs, "amin")
        hi = torch.full((p,), float("-inf"), device=v.device).scatter_reduce(
            0, rs, vs, "amax")
        span = torch.clamp_min(hi[rs] - lo[rs], 1e-12)
        inner = torch.zeros(p, dtype=torch.bool, device=v.device)
        inner[1:-1] = (rs[1:-1] == rs[:-2]) & (rs[1:-1] == rs[2:])
        d = torch.full((p,), BIG, device=v.device)
        d[1:-1] = torch.where(inner[1:-1], (vs[2:] - vs[:-2]) / span[1:-1],
                              BIG)
        term = torch.empty_like(d)
        term[order] = d
        total = term if total is None else total + term
    return total


def draws(gen: torch.Generator, p: int, g: int, device) -> dict:
    kw = dict(generator=gen, device=device)
    return {
        "a": torch.randint(0, p, (p,), **kw),
        "b": torch.randint(0, p, (p,), **kw),
        "sbx_u": torch.rand((p // 2, g), **kw),
        "sbx_do": torch.rand((p // 2,), **kw),
        "sbx_swap": torch.rand((p // 2, g), **kw),
        "mut_u": torch.rand((p, g), **kw),
        "mut_mask": torch.rand((p, g), **kw),
    }


def _pow(base, e):
    return (base.to(torch.float64) ** e).to(torch.float32)


def children(genes, rank, crowd, d: dict) -> torch.Tensor:
    p, g = genes.shape
    a, b = d["a"], d["b"]
    a_wins = (rank[a] < rank[b]) | ((rank[a] == rank[b]) & (crowd[a] >= crowd[b]))
    parents = torch.where(a_wins, a, b)
    pa, pb = genes[parents[0::2]], genes[parents[1::2]]
    e = 1.0 / (ETA_C + 1.0)
    u = d["sbx_u"]
    beta = torch.where(u <= 0.5, _pow(2.0 * u, e),
                       _pow(1.0 / (2.0 * (1.0 - u)), e))
    c1 = 0.5 * ((1 + beta) * pa + (1 - beta) * pb)
    c2 = 0.5 * ((1 - beta) * pa + (1 + beta) * pb)
    cross = (d["sbx_do"] < P_CROSS)[:, None]
    c1, c2 = torch.where(cross, c1, pa), torch.where(cross, c2, pb)
    swap = d["sbx_swap"] < 0.5
    kids = torch.cat([torch.where(swap, c1, c2).clamp(0.0, 1.0),
                      torch.where(swap, c2, c1).clamp(0.0, 1.0)])[:p]
    e = 1.0 / (ETA_M + 1.0)
    u = d["mut_u"]
    delta = torch.where(u < 0.5, _pow(2.0 * u, e) - 1.0,
                        1.0 - _pow(2.0 * (1.0 - u), e))
    step = torch.where(d["mut_mask"] < 1.0 / g, delta, 0.0)
    return torch.clamp(kids + step, 0.0, 1.0)


def generation(state: dict, objectives, d: dict) -> dict:
    p = state["genes"].shape[0]
    kids = children(state["genes"], state["rank"], state["crowd"], d)
    genes = torch.cat([state["genes"], kids])
    objs = torch.cat([state["objs"], objectives(kids)])
    rank = fronts(objs)
    crowd = crowding(objs, rank)
    key = rank.to(torch.float32) * BIG - torch.clamp_max(crowd, BIG / 2)
    keep = torch.argsort(key, stable=True)[:p]
    return {"genes": genes[keep], "objs": objs[keep], "rank": rank[keep],
            "crowd": crowd[keep]}


def follow(start: dict, gen_state: torch.Tensor, n_generations: int,
           objectives, device) -> dict:
    """``n_generations`` generations from ``start`` (genes, objs, rank,
    crowd), drawing from a generator at ``gen_state``."""
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    state = {k: torch.as_tensor(v, device=device) for k, v in start.items()}
    p, g = state["genes"].shape
    for _ in range(n_generations):
        state = generation(state, objectives, draws(gen, p, g, device))
    return state
