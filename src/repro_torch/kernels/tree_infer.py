"""Per-class votes of approximate trees: Hopper kernel and plain version.

Replaces the TPU kernel `repro/kernels/tree_infer.py::tree_infer_scores`.
For chromosomes p (per-comparator shift ``8 - bits`` and threshold) and
samples b it returns the (P, B, C) vote counts of the dataflow

    x_p   = x8[b, feature[n]] >> shift[p, n]   (indexed load, no one-hot)
    d     = x_p > thr[p, n]
    score = d @ PATH^T ;  sat = score == target ;  votes = sat @ CLS1H

(`csrc/tree_infer.cu`: a block per chromosome and tile of 16 samples, the
tile's decisions packed by warp ballots into shared memory, the leaf axis
spread over the block's threads). What bounds
it on the H100, and what the design does about it, is stated in the CUDA
source. On a CPU tensor the wrapper runs the plain PyTorch version below;
on a CUDA tensor it launches the kernel or raises. Its operands hold the
path matrix packed into +1 / -1 bit masks of ``mask_words(N)`` words per
leaf, rows 16-byte aligned; the plain dataflow `leaf_votes_plain` is
shared with the fitness kernel's plain version.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build

# 32-bit words per leaf mask the CUDA kernel is instantiated for; must
# equal REPRO_NWP_CASES in csrc/tree_infer.cu (a test holds them equal).
# 64 words = 2048 comparators.
NWP_CHOICES = (4, 8, 12, 16, 20, 24, 28, 32, 48, 64)
PLAIN_CHUNK = 8  # chromosomes per step of the plain versions


def mask_words(n_comparators: int) -> int:
    """Smallest instantiated mask width holding ``n_comparators`` bits."""
    need = -(-n_comparators // 32)
    for w in NWP_CHOICES:
        if w >= need:
            return w
    raise ValueError(
        f"{n_comparators} comparators exceed the kernels' largest mask "
        f"({NWP_CHOICES[-1] * 32} bits)")


def pack_path(path: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, N) int8 path in {-1, 0, 1} -> (pos, neg), each (L, W) int32 bit
    masks (bit n of word w is comparator 32w + n), W = `mask_words(N)`."""
    n_leaves, n = path.shape
    words = mask_words(n)
    bit = torch.arange(32, device=path.device, dtype=torch.int64)

    def pack(mask):
        padded = torch.zeros((n_leaves, words * 32), dtype=torch.int64,
                             device=path.device)
        padded[:, :n] = mask.to(torch.int64)
        w = (padded.view(n_leaves, words, 32) << bit).sum(-1)
        return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)

    return pack(path == 1), pack(path == -1)


@dataclasses.dataclass
class TreeOperands:
    """Static operands of `tree_infer_scores` for one tree layout."""

    feature: torch.Tensor     # (N,) int32 feature read by each comparator
    path: torch.Tensor        # (L, N) int8 in {-1, 0, 1} (plain version)
    pos: torch.Tensor         # (L, W) int32 bit masks of the +1 entries
    neg: torch.Tensor         # (L, W) int32 bit masks of the -1 entries
    target: torch.Tensor      # (L,) int32 score of a satisfied leaf
    leaf_class: torch.Tensor  # (L,) int32 in [0, n_classes)
    n_classes: int
    n_features: int

    @property
    def device(self) -> torch.device:
        return self.path.device


def leaf_votes_plain(x_sel: torch.Tensor, shift: torch.Tensor,
                     thr: torch.Tensor, path: torch.Tensor,
                     target: torch.Tensor, leaf_class: torch.Tensor,
                     n_classes: int):
    """(P, B, C) int32 votes of the dataflow for gathered codes ``x_sel``
    (B, N) and chromosome operands (P, N). The path and vote products run
    in float32: their operands are 0, 1 or -1 and every sum is an integer
    below 2^24, which float32 (and TF32) hold exactly."""
    x = x_sel.to(torch.int32)
    path_t = path.to(torch.float32).T
    cls1h = torch.nn.functional.one_hot(
        leaf_class.long(), n_classes).to(torch.float32)
    out = []
    for p0 in range(0, shift.shape[0], PLAIN_CHUNK):
        s = shift[p0:p0 + PLAIN_CHUNK, None, :]
        t = thr[p0:p0 + PLAIN_CHUNK, None, :]
        d = ((x[None] >> s) > t).to(torch.float32)          # (p, B, N)
        sat = (d @ path_t) == target.to(torch.float32)      # (p, B, L)
        votes = sat.to(torch.float32) @ cls1h
        out.append(votes.to(torch.int32))
    if not out:
        return torch.zeros((0, x.shape[0], n_classes), dtype=torch.int32,
                           device=x.device)
    return torch.cat(out)


def tree_infer_scores_plain(x8: torch.Tensor, ops: TreeOperands,
                            shift: torch.Tensor,
                            thr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `tree_infer_scores`."""
    x_sel = x8[:, ops.feature.long()]
    return leaf_votes_plain(x_sel, shift, thr, ops.path, ops.target,
                            ops.leaf_class, ops.n_classes)


def tree_infer_scores(x8: torch.Tensor, ops: TreeOperands,
                      shift: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """(P, B, C) int32 per-class votes; x8 (B, F) int32 master codes,
    shift/thr (P, N) int32. Counts its kernel launches in
    ``tree_infer_scores.launches``."""
    if not _build.on_cuda(x8, "tree_infer_scores"):
        return tree_infer_scores_plain(x8, ops, shift, thr)
    dev = x8.device
    n_pop, n = shift.shape
    batch = x8.shape[0]
    n_leaves, words = ops.pos.shape
    _build.require(x8, "x8", torch.int32, dev, (batch, ops.n_features))
    for name, t in (("shift", shift), ("thr", thr)):
        _build.require(t, name, torch.int32, dev, (n_pop, n))
    _build.require(ops.feature, "feature", torch.int32, dev, (n,))
    if words != mask_words(n):
        raise ValueError(f"path masks have {words} words per leaf, "
                         f"expected {mask_words(n)} for {n} comparators")
    for name in ("pos", "neg"):
        _build.require(getattr(ops, name), name, torch.int32, dev,
                       (n_leaves, words))
        if getattr(ops, name).data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    for name in ("target", "leaf_class"):
        _build.require(getattr(ops, name), name, torch.int32, dev, (n_leaves,))
    votes = torch.empty((n_pop, batch, ops.n_classes), dtype=torch.int32,
                        device=dev)
    if n_pop == 0 or batch == 0 or ops.n_classes == 0:
        return votes
    fn = _build.function("tree_infer", "repro_tree_infer_scores", 9, 7)
    rc = fn(_build.ptr(x8), _build.ptr(ops.feature), _build.ptr(shift),
            _build.ptr(thr), _build.ptr(ops.pos), _build.ptr(ops.neg),
            _build.ptr(ops.target), _build.ptr(ops.leaf_class),
            _build.ptr(votes), n_pop, batch, ops.n_features, n, n_leaves,
            ops.n_classes, words, _build.stream(dev))
    _build.check_launch(rc, "tree_infer_scores")
    tree_infer_scores.launches += 1
    return votes


tree_infer_scores.launches = 0
