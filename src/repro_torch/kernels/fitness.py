"""Fused population fitness: Hopper kernel and plain version.

Replaces the TPU kernel `repro/kernels/fitness.py::fitness_errors`. For
every chromosome p it counts the test samples the approximate tree
classifies correctly:

    x_p   = x_sel >> shift[p]          (x_sel: the hoisted x8[:, feature])
    d     = x_p > thr[p]
    votes = (d @ PATH^T == target) @ CLS1H,  clipped to vote_cap[p]
    count = sum_b (first-max argmax(votes) == y[b])

Only the (P,) counts leave the kernel (`csrc/fitness.cu`: the path product
``d @ PATH^T`` as an s8 x s8 -> s32 product on the int8 tensor cores, each
leaf tile of 32 over its own comparator span, so any N runs and a forest's
block diagonal costs less than the trees' own products: the har forest of
five trees (N = 2,227, L = 2,232) runs 662,528 multiply-adds a
(chromosome, sample) row, 66% of sum_k N_k L_k and 13% of the dense
product, counted in ``fitness.path_macs``; what bounds it on the H100 and
how the design answers is stated there). The
TPU kernel's (P, 128) lane-replicated output was a layout artifact; this
returns (P,). Everything is integer: `floor(x * 2^-(8-p))` of the TPU
kernel is ``x >> (8 - p)`` on integer codes, and ``vote_cap`` is an int32
(1 for the approximate vote adder, `repro_torch.core.quant.NO_VOTE_CAP` for
the exact one). On a CPU tensor the wrapper runs the plain PyTorch
version; on a CUDA tensor it launches the kernel or raises.

A sweep bucket's problems, padded to one shape, stack on a leading problem
axis (`stack_operands`): shift and thr (K, P, N), vote_cap (K, P), counts
(K, P), one launch for the whole bucket (the kernel's ``blockIdx.z``). A
single problem is the same launch with K = 1.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tree_infer import PLAIN_CHUNK, leaf_votes_plain
from repro_torch.runtime import trace

# The operand layout of csrc/fitness.cu (a test holds the two files equal):
# K (comparators) padded to a multiple of K_ALIGN bytes, leaves to a
# multiple of LEAF_TILE. Each leaf tile carries its comparator span, and a
# block holds at most MAX_CHUNK comparators of it at a time. A block of the
# kernel holds BLOCK_ROWS (chromosome, sample) rows.
K_ALIGN = 32
MAX_CHUNK = 1024
LEAF_TILE = 32
BLOCK_ROWS = 256


def k_padded(n_comparators: int) -> int:
    """Comparator axis of the kernel's operands for N comparators."""
    return max(K_ALIGN, -(-n_comparators // K_ALIGN) * K_ALIGN)


def tile_spans(path: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    """(spans, chunk, columns) of a padded path (L_pad, K_pad): spans (L_pad
    / LEAF_TILE, 2) int32, each tile's [lo, hi) from the first to the last
    nonzero column of its rows, widened to multiples of K_ALIGN (one
    K_ALIGN step where a tile has none: its scores are all 0); chunk the
    widest span, at most MAX_CHUNK, the comparators the kernel holds at a
    time; columns the spans' widths summed, sum(hi - lo): a row's path
    product runs LEAF_TILE * columns multiply-adds."""
    l_pad, k_pad = path.shape
    live = (path != 0).view(l_pad // LEAF_TILE, LEAF_TILE, k_pad).any(1)
    any_live = live.any(1)
    col = torch.arange(k_pad, device=path.device)
    first = torch.where(live, col, k_pad).amin(1)
    last = torch.where(live, col, -1).amax(1)
    lo = torch.where(any_live, first // K_ALIGN * K_ALIGN, 0)
    hi = torch.where(any_live, (last // K_ALIGN + 1) * K_ALIGN, K_ALIGN)
    spans = torch.stack([lo, hi], 1).to(torch.int32).contiguous()
    chunk = min(MAX_CHUNK, int((hi - lo).max())) if l_pad else K_ALIGN
    return spans, chunk, int((hi - lo).sum())


@dataclasses.dataclass
class FitnessOperands:
    """Chromosome-invariant operands of `fitness_correct_counts`, in the
    kernel's layout: K contiguous, padded with zeros (comparators past N
    never fire and have zero path entries); leaves past L have a zero path
    row and a target no score reaches (|score| <= N); `tile_spans` of the
    path."""

    x_sel: torch.Tensor       # (B, K_pad) uint8 gathered codes
    y: torch.Tensor           # (B,) int32 labels; -1 rows never count
    path: torch.Tensor        # (L_pad, K_pad) int8 in {-1, 0, 1}
    spans: torch.Tensor       # (L_pad / LEAF_TILE, 2) int32 [lo, hi) a tile
    target: torch.Tensor      # (L_pad,) int32 score of a satisfied leaf
    leaf_class: torch.Tensor  # (L_pad,) int32 in [0, n_classes)
    n_comparators: int        # N
    n_classes: int
    n_valid: int | tuple      # rows with a label >= 0 (per problem, stacked)
    chunk: int                # comparators the kernel holds at a time
    span_columns: int | tuple  # sum(hi - lo) of `spans` (per problem)

    @property
    def device(self) -> torch.device:
        return self.path.device

    @property
    def stacked(self) -> bool:
        """True for a bucket's operands on a leading problem axis."""
        return self.path.dim() == 3

    def member(self, i: int) -> "FitnessOperands":
        """Problem ``i`` of stacked operands, as single-problem operands."""
        return dataclasses.replace(
            self, x_sel=self.x_sel[i], y=self.y[i], path=self.path[i],
            spans=self.spans[i], target=self.target[i],
            leaf_class=self.leaf_class[i], n_valid=self.n_valid[i],
            span_columns=self.span_columns[i])

    def path_macs(self, n_pop: int, batch: int) -> int:
        """The int8 multiply-adds a launch's path product runs for
        ``n_pop`` chromosomes of ``batch`` samples, each problem's: every
        (chromosome, sample) row runs each leaf tile over its span."""
        columns = (sum(self.span_columns) if self.stacked
                   else self.span_columns)
        return n_pop * batch * LEAF_TILE * columns


def stack_operands(members) -> FitnessOperands:
    """One bucket's operands: same-shape single-problem operands (one N,
    n_classes, B and L_pad) stacked on a leading problem axis, with the
    widest member's chunk."""
    members = list(members)
    first = members[0]
    for m in members[1:]:
        if (m.n_comparators != first.n_comparators
                or m.n_classes != first.n_classes
                or m.x_sel.shape != first.x_sel.shape
                or m.path.shape != first.path.shape):
            raise ValueError("a bucket's operands must share one shape")

    def stack(name):
        return torch.stack([getattr(m, name) for m in members]).contiguous()

    return FitnessOperands(
        x_sel=stack("x_sel"), y=stack("y"), path=stack("path"),
        spans=stack("spans"), target=stack("target"),
        leaf_class=stack("leaf_class"), n_comparators=first.n_comparators,
        n_classes=first.n_classes,
        n_valid=tuple(m.n_valid for m in members),
        chunk=max(m.chunk for m in members),
        span_columns=tuple(m.span_columns for m in members))


def fitness_correct_counts_plain(ops: FitnessOperands, shift: torch.Tensor,
                                 thr: torch.Tensor,
                                 vote_cap: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `fitness_correct_counts`; stacked operands
    loop over their problems."""
    if ops.stacked:
        return torch.stack([
            fitness_correct_counts_plain(ops.member(i), shift[i], thr[i],
                                         vote_cap[i])
            for i in range(ops.path.shape[0])])
    n = ops.n_comparators
    x_sel, path = ops.x_sel[:, :n], ops.path[:, :n]
    counts = []
    for p0 in range(0, shift.shape[0], PLAIN_CHUNK):
        votes = leaf_votes_plain(x_sel, shift[p0:p0 + PLAIN_CHUNK],
                                 thr[p0:p0 + PLAIN_CHUNK], path,
                                 ops.target, ops.leaf_class, ops.n_classes)
        votes = torch.minimum(votes, vote_cap[p0:p0 + PLAIN_CHUNK, None, None])
        pred = torch.argmax(votes, dim=-1)                  # first max
        counts.append((pred == ops.y[None].long()).sum(-1).to(torch.int32))
    if not counts:
        return torch.zeros((0,), dtype=torch.int32, device=shift.device)
    return torch.cat(counts)


def fitness_correct_counts(ops: FitnessOperands, shift: torch.Tensor,
                           thr: torch.Tensor,
                           vote_cap: torch.Tensor) -> torch.Tensor:
    """(P,) int32 correct-sample counts; shift/thr (P, N) int32, vote_cap
    (P,) int32. With stacked operands (K problems) shift/thr are (K, P, N),
    vote_cap (K, P) and the counts (K, P), still one launch. Counts its
    kernel launches in ``launches.fitness_correct_counts`` and the path
    product's multiply-adds in ``fitness.path_macs`` (`FitnessOperands.
    path_macs`); the plain version counts neither."""
    if not _build.on_cuda(shift, "fitness_correct_counts"):
        return fitness_correct_counts_plain(ops, shift, thr, vote_cap)
    dev = shift.device
    lead = ops.path.shape[:-2]          # (K,) stacked, () single
    n_prob = ops.path.shape[0] if ops.stacked else 1
    if shift.dim() != len(lead) + 2 or tuple(shift.shape[:-2]) != tuple(lead):
        raise ValueError(f"shift {tuple(shift.shape)} does not fit operands "
                         f"of {n_prob} problem(s)")
    n_pop, n = shift.shape[-2:]
    batch, k_pad = ops.x_sel.shape[-2:]
    l_pad = ops.path.shape[-2]
    if n != ops.n_comparators or k_pad != k_padded(n) or l_pad % LEAF_TILE:
        raise ValueError(f"operands for {ops.n_comparators} comparators "
                         f"(K_pad {k_pad}, L_pad {l_pad}) do not fit {n}")
    if n_prob > 65535:
        raise ValueError(f"{n_prob} problems exceed the grid's 65535")
    _build.require(ops.x_sel, "x_sel", torch.uint8, dev, (*lead, batch, k_pad))
    _build.require(ops.path, "path", torch.int8, dev, (*lead, l_pad, k_pad))
    _build.require(ops.spans, "spans", torch.int32, dev,
                   (*lead, l_pad // LEAF_TILE, 2))
    if ops.chunk % K_ALIGN or not K_ALIGN <= ops.chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {ops.chunk} is not a multiple of {K_ALIGN} "
                         f"in [{K_ALIGN}, {MAX_CHUNK}]")
    for name in ("target", "leaf_class"):
        _build.require(getattr(ops, name), name, torch.int32, dev,
                       (*lead, l_pad))
    _build.require(shift, "shift", torch.int32, dev)
    _build.require(thr, "thr", torch.int32, dev, (*lead, n_pop, n))
    _build.require(vote_cap, "vote_cap", torch.int32, dev, (*lead, n_pop))
    _build.require(ops.y, "y", torch.int32, dev, (*lead, batch))
    correct = torch.zeros((*lead, n_pop), dtype=torch.int32, device=dev)
    if n_pop == 0 or batch == 0 or n_prob == 0:
        return correct
    fn = _build.function("fitness", "repro_fitness_correct_counts", 10, 8)
    rc = fn(_build.ptr(ops.x_sel), _build.ptr(shift), _build.ptr(thr),
            _build.ptr(ops.path), _build.ptr(ops.spans),
            _build.ptr(ops.target), _build.ptr(ops.leaf_class),
            _build.ptr(ops.y), _build.ptr(vote_cap), _build.ptr(correct),
            n_prob, n_pop, batch, n, k_pad, l_pad, ops.n_classes, ops.chunk,
            _build.stream(dev))
    _build.check_launch(rc, "fitness_correct_counts")
    trace.count("launches.fitness_correct_counts")
    trace.count("fitness.path_macs", ops.path_macs(n_pop, batch))
    return correct


