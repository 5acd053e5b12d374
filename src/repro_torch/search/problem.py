"""`SearchProblem`: the evaluation context of one tree or forest and its
test set.

The counterpart of `repro.search.problem`. The comparator axis concatenates
every tree's comparators and the leaf axis every tree's leaves, with `path`
the block-diagonal super-tree (`core.tree.concatenate_ptrees`), so one
dataflow evaluates every tree and its class-vote product counts one vote
per tree (a single tree is the K = 1 case). The arrays live on the
problem's device as tensors; the chromosome is 3N+1 genes (precision,
margin and truncation per comparator, plus the forest's vote-adder gene,
inert for one tree).

Objectives are (accuracy loss vs the exact design, normalised area), both
minimised. The accuracy term equals the reference's: every quantity is an
integer and the final division is the same float32 division. The area term
is held to the integer-quanta LUT (`core.area.build_area_unit_lut`): the
port sums integer quanta, exact in any order on any device, adds the vote
adder of the decoded mode (whole quanta, `core.area.vote_adder_units`; 0
for one tree) and divides once, ``float32(units) / float32(exact_units)``.
The JAX package sums the float mm^2 LUT in float32, so the two areas agree
to float32 rounding (about 1e-7 relative), and the exact design scores
exactly 1.0 here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import area as area_mod
from repro_torch.core import quant
from repro_torch.core.tree import ParallelTree, concatenate_ptrees
from repro_torch.datasets.synthetic import quantize_u8
from repro_torch.device import resolve_device


@dataclasses.dataclass
class SearchProblem:
    """Evaluation context for one (tree ensemble, test set) pair; arrays
    concatenated over the K trees, `path` block diagonal."""

    feature: torch.Tensor      # (N,) int32 comparator features
    threshold: torch.Tensor    # (N,) float32 trained float thresholds
    path: torch.Tensor         # (L, N) int8 path matrix in {-1, 0, 1}
    path_len: torch.Tensor     # (L,) int32
    n_neg: torch.Tensor        # (L,) int32
    leaf_class: torch.Tensor   # (L,) int32
    leaf_tree: torch.Tensor    # (L,) int32 owning tree per leaf
    x8: torch.Tensor           # (B, F) int32 master codes (test set)
    x_sel: torch.Tensor        # (B, N) int32 hoisted x8[:, feature]
    y: torch.Tensor            # (B,) int32
    area_units: torch.Tensor   # flat comparator LUT in integer quanta, int32
    lut_offsets: torch.Tensor  # (MAX_BITS+1,) int64 row start per precision
    overhead_units: int        # per-node/leaf overheads in quanta
    exact_units: int           # exact design's area in quanta
    exact_accuracy: float
    n_classes: int
    n_features: int
    n_trees: int
    tree_comparators: tuple
    tree_leaves: tuple
    vote_units_exact: int = 0   # vote-stage area per adder mode, in quanta
    vote_units_approx: int = 0  # (both 0 for one tree)

    @property
    def device(self) -> torch.device:
        return self.x8.device

    @property
    def n_comparators(self) -> int:
        return int(self.feature.shape[0])

    @property
    def n_leaves(self) -> int:
        return int(self.leaf_class.shape[0])

    @property
    def n_genes(self) -> int:
        return 3 * self.n_comparators + 1

    @property
    def exact_area_mm2(self) -> float:
        return self.exact_units * area_mod.AREA_QUANTUM_MM2

    @property
    def overhead_mm2(self) -> float:
        return self.overhead_units * area_mod.AREA_QUANTUM_MM2

    def exact_genes(self) -> np.ndarray:
        """Chromosome of the exact (8-bit, zero-margin, un-truncated,
        exact-vote) reference design."""
        return quant.exact_tree_genes(self.n_comparators)


def decode_chromosome(problem: SearchProblem, genes: torch.Tensor):
    """genes (..., 3N+1) -> (bits, t_sub, vote_cap): the EFFECTIVE design,
    truncation folded in (width p - k, threshold t' >> k), and the int32
    vote cap (1 approximate adder, `quant.NO_VOTE_CAP` exact)."""
    bits, margin, trunc, vote = quant.decode_tree_genes(genes)
    t_int = quant.threshold_to_int(problem.threshold, bits)
    t_sub = quant.substitute(t_int, margin, bits)
    return bits - trunc, t_sub >> trunc, quant.vote_cap_of(vote)


def predict_votes(problem: SearchProblem, bits: torch.Tensor,
                  t_sub: torch.Tensor, vote_cap=None) -> torch.Tensor:
    """Voted class per sample, (B,) for bits (N,) or (P, B) for (P, N).

    The comparator -> path -> leaf -> vote dataflow on the hoisted feature
    gather; the path and vote products run in float32, exact for their
    {0, +-1} operands and integer sums below 2^24.
    """
    single = bits.dim() == 1
    bits2 = bits[None] if single else bits
    t2 = t_sub[None] if single else t_sub
    path_t = problem.path.to(torch.float32).T
    target = (problem.path_len - problem.n_neg).to(torch.float32)
    cls1h = torch.nn.functional.one_hot(
        problem.leaf_class.long(), problem.n_classes).to(torch.float32)
    caps = None
    if vote_cap is not None:
        caps = torch.as_tensor(vote_cap, device=bits2.device).reshape(-1)
        caps = caps.to(torch.float32).expand(bits2.shape[0])
    preds = []
    for p0 in range(0, bits2.shape[0], 8):
        x_p = quant.inputs_at_precision(problem.x_sel[None],
                                        bits2[p0:p0 + 8, None, :])
        d = (x_p > t2[p0:p0 + 8, None, :]).to(torch.float32)
        sat = (d @ path_t == target).to(torch.float32)
        votes = sat @ cls1h                                  # (p, B, C)
        if caps is not None:
            votes = torch.minimum(votes, caps[p0:p0 + 8, None, None])
        preds.append(torch.argmax(votes, dim=-1))
    pred = torch.cat(preds)
    return pred[0] if single else pred


def vote_area_units(problem: SearchProblem,
                    vote_cap: torch.Tensor) -> torch.Tensor:
    """The vote stage's quanta of the decoded adder mode: the approximate
    adder where the cap is 1, else the exact one (0 for one tree)."""
    return torch.where(vote_cap == 1, problem.vote_units_approx,
                       problem.vote_units_exact)


def area_units(problem: SearchProblem, bits: torch.Tensor,
               t_sub: torch.Tensor, vote_cap: torch.Tensor) -> torch.Tensor:
    """(...,) int64 area in quanta: comparator LUT + overheads + the vote
    adder of the decoded mode."""
    idx = problem.lut_offsets[bits.long()] + t_sub.long()
    return (problem.area_units[idx].sum(-1) + problem.overhead_units
            + vote_area_units(problem, vote_cap))


def normalized_area(problem: SearchProblem, units: torch.Tensor):
    return units.to(torch.float32) / float(problem.exact_units)


def accuracy(correct: torch.Tensor, n: int) -> torch.Tensor:
    """float32 accuracy of ``correct`` counts over ``n`` samples, rounded as
    the reference's `jnp.mean` rounds it: the count times the float32
    reciprocal of ``n`` (not a division, which can differ by one ulp)."""
    inv = torch.full((), float(np.float32(1) / np.float32(n)),
                     dtype=torch.float32, device=correct.device)
    return correct.to(torch.float32) * inv


def objectives(problem: SearchProblem, genes: torch.Tensor) -> torch.Tensor:
    """(P, 2) float32 (accuracy loss vs exact, normalised area) of genes
    (P, 3N+1); ONE decode feeds both objectives."""
    bits, t_sub, vote_cap = decode_chromosome(problem, genes)
    pred = predict_votes(problem, bits, t_sub, vote_cap)
    acc = accuracy((pred == problem.y.long()).sum(-1), problem.y.shape[0])
    loss = torch.full((), problem.exact_accuracy, dtype=torch.float32,
                      device=acc.device) - acc
    return torch.stack([loss, normalized_area(
        problem, area_units(problem, bits, t_sub, vote_cap))], dim=-1)


def chromosome_accuracy(problem: SearchProblem,
                        genes: torch.Tensor) -> torch.Tensor:
    """float32 test accuracy of one chromosome (3N+1,)."""
    bits, t_sub, vote_cap = decode_chromosome(problem, genes)
    pred = predict_votes(problem, bits, t_sub, vote_cap)
    return accuracy((pred == problem.y.long()).sum(), problem.y.shape[0])


def chromosome_area_mm2(problem: SearchProblem, genes: torch.Tensor) -> float:
    """The LUT area estimate of one chromosome: comparators + overheads +
    the vote adder of its mode, in mm^2 (whole quanta)."""
    bits, t_sub, vote_cap = decode_chromosome(problem, genes)
    units = area_units(problem, bits, t_sub, vote_cap)
    return int(units) * area_mod.AREA_QUANTUM_MM2


def build_problem(ptrees, x_test: np.ndarray, y_test: np.ndarray,
                  n_classes: int | None = None,
                  device="cuda") -> SearchProblem:
    """Build a SearchProblem from one `ParallelTree` or a list of them (a
    forest: one joint chromosome over the block-diagonal super-tree)."""
    dev = resolve_device(device)
    if isinstance(ptrees, ParallelTree):
        ptrees = [ptrees]
    if n_classes is None:
        n_classes = max(pt.n_classes for pt in ptrees)
    arrays = concatenate_ptrees(ptrees)
    feature = arrays["feature"]
    n_total, l_total = feature.shape[0], arrays["leaf_class"].shape[0]
    units_lut, offsets = area_mod.build_area_unit_lut()
    x8 = quantize_u8(x_test).astype(np.int32)
    overhead = area_mod.tree_overhead_units(n_total, l_total)
    vote_exact = area_mod.vote_adder_units(len(ptrees), int(n_classes),
                                           approx=False)
    vote_approx = area_mod.vote_adder_units(len(ptrees), int(n_classes),
                                            approx=True)
    t8 = np.clip(np.floor(arrays["threshold"].astype(np.float64) * 256.0),
                 0, 255).astype(np.int64)
    exact_units = (int(units_lut[offsets[quant.MAX_BITS] + t8].astype(
        np.int64).sum()) + overhead + vote_exact)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    problem = SearchProblem(
        feature=t(feature, torch.int32),
        threshold=t(arrays["threshold"], torch.float32),
        path=t(arrays["path"], torch.int8),
        path_len=t(arrays["path_len"], torch.int32),
        n_neg=t(arrays["n_neg"], torch.int32),
        leaf_class=t(arrays["leaf_class"], torch.int32),
        leaf_tree=t(arrays["leaf_tree"], torch.int32),
        x8=t(x8, torch.int32),
        x_sel=t(x8[:, feature], torch.int32),
        y=t(y_test.astype(np.int32), torch.int32),
        area_units=t(units_lut.astype(np.int32), torch.int32),
        lut_offsets=t(offsets, torch.int64),
        overhead_units=int(overhead),
        exact_units=exact_units,
        exact_accuracy=0.0,  # filled below
        n_classes=int(n_classes),
        n_features=int(x_test.shape[1]),
        n_trees=len(ptrees),
        tree_comparators=tuple(pt.n_comparators for pt in ptrees),
        tree_leaves=tuple(pt.n_leaves for pt in ptrees),
        vote_units_exact=int(vote_exact),
        vote_units_approx=int(vote_approx),
    )
    genes = torch.as_tensor(problem.exact_genes(), device=dev)
    acc = chromosome_accuracy(problem, genes)
    return dataclasses.replace(problem, exact_accuracy=float(acc))


def build_tree_problem(ptree: ParallelTree, x_test, y_test,
                       device="cuda") -> SearchProblem:
    return build_problem(ptree, x_test, y_test, device=device)


def build_forest_problem(forest, x_test, y_test,
                         device="cuda") -> SearchProblem:
    """``forest`` is a `repro_torch.core.forest.Forest`."""
    return build_problem(list(forest.ptrees), x_test, y_test,
                         n_classes=forest.n_classes, device=device)


def problem_ptrees(problem: SearchProblem) -> list:
    """The per-tree `ParallelTree`s (numpy) of the concatenated layout, the
    block-diagonal path sliced apart by the per-tree counts."""
    feature = problem.feature.cpu().numpy()
    threshold = problem.threshold.cpu().numpy()
    path = problem.path.cpu().numpy()
    path_len = problem.path_len.cpu().numpy()
    n_neg = problem.n_neg.cpu().numpy()
    leaf_class = problem.leaf_class.cpu().numpy()
    ptrees, n_off, l_off = [], 0, 0
    for n_k, l_k in zip(problem.tree_comparators, problem.tree_leaves):
        block = path[l_off:l_off + l_k, n_off:n_off + n_k]
        if n_k == 0:  # single-leaf tree: ParallelTree keeps one dummy column
            block = np.zeros((l_k, 1), np.int8)
        ptrees.append(ParallelTree(
            feature=feature[n_off:n_off + n_k],
            threshold=threshold[n_off:n_off + n_k],
            path=np.ascontiguousarray(block),
            path_len=path_len[l_off:l_off + l_k],
            n_neg=n_neg[l_off:l_off + l_k],
            leaf_class=leaf_class[l_off:l_off + l_k],
            n_classes=problem.n_classes,
        ))
        n_off += n_k
        l_off += l_k
    return ptrees
