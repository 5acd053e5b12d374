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
leaf tile over its own comparator span, so any N and a forest's block
diagonal cost only the trees' products; what bounds it on the H100 and how
the design answers is stated there). The
TPU kernel's (P, 128) lane-replicated output was a layout artifact; this
returns (P,). Everything is integer: `floor(x * 2^-(8-p))` of the TPU
kernel is ``x >> (8 - p)`` on integer codes, and ``vote_cap`` is an int32
(1 for the approximate vote adder, `repro_torch.core.quant.NO_VOTE_CAP` for
the exact one). On a CPU tensor the wrapper runs the plain PyTorch
version; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tree_infer import PLAIN_CHUNK, leaf_votes_plain

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


def tile_spans(path: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(spans, chunk) of a padded path (L_pad, K_pad): spans (L_pad /
    LEAF_TILE, 2) int32, each tile's [lo, hi) from the first to the last
    nonzero column of its rows, widened to multiples of K_ALIGN (one
    K_ALIGN step where a tile has none: its scores are all 0); chunk the
    widest span, at most MAX_CHUNK, the comparators the kernel holds at a
    time."""
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
    return spans, chunk


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
    n_valid: int              # rows with a label >= 0
    chunk: int                # comparators the kernel holds at a time

    @property
    def device(self) -> torch.device:
        return self.path.device


def fitness_correct_counts_plain(ops: FitnessOperands, shift: torch.Tensor,
                                 thr: torch.Tensor,
                                 vote_cap: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `fitness_correct_counts`."""
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
    (P,) int32. Counts its kernel launches in
    ``fitness_correct_counts.launches``."""
    if not _build.on_cuda(shift, "fitness_correct_counts"):
        return fitness_correct_counts_plain(ops, shift, thr, vote_cap)
    dev = shift.device
    n_pop, n = shift.shape
    batch, k_pad = ops.x_sel.shape
    l_pad = ops.path.shape[0]
    if n != ops.n_comparators or k_pad != k_padded(n) or l_pad % LEAF_TILE:
        raise ValueError(f"operands for {ops.n_comparators} comparators "
                         f"(K_pad {k_pad}, L_pad {l_pad}) do not fit {n}")
    _build.require(ops.x_sel, "x_sel", torch.uint8, dev, (batch, k_pad))
    _build.require(ops.path, "path", torch.int8, dev, (l_pad, k_pad))
    _build.require(ops.spans, "spans", torch.int32, dev,
                   (l_pad // LEAF_TILE, 2))
    if ops.chunk % K_ALIGN or not K_ALIGN <= ops.chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {ops.chunk} is not a multiple of {K_ALIGN} "
                         f"in [{K_ALIGN}, {MAX_CHUNK}]")
    for name in ("target", "leaf_class"):
        _build.require(getattr(ops, name), name, torch.int32, dev, (l_pad,))
    _build.require(shift, "shift", torch.int32, dev)
    _build.require(thr, "thr", torch.int32, dev, (n_pop, n))
    _build.require(vote_cap, "vote_cap", torch.int32, dev, (n_pop,))
    _build.require(ops.y, "y", torch.int32, dev, (batch,))
    correct = torch.zeros((n_pop,), dtype=torch.int32, device=dev)
    if n_pop == 0 or batch == 0:
        return correct
    fn = _build.function("fitness", "repro_fitness_correct_counts", 10, 7)
    rc = fn(_build.ptr(ops.x_sel), _build.ptr(shift), _build.ptr(thr),
            _build.ptr(ops.path), _build.ptr(ops.spans),
            _build.ptr(ops.target), _build.ptr(ops.leaf_class),
            _build.ptr(ops.y), _build.ptr(vote_cap), _build.ptr(correct),
            n_pop, batch, n, k_pad, l_pad, ops.n_classes, ops.chunk,
            _build.stream(dev))
    _build.check_launch(rc, "fitness_correct_counts")
    fitness_correct_counts.launches += 1
    return correct


fitness_correct_counts.launches = 0
