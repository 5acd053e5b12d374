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
path matrix packed into +1 / -1 bit masks (`pack_path`): each leaf's masks
cover its own span from a word offset, as wide as the widest leaf needs,
so any comparator count fits; the plain dataflow `leaf_votes_plain` is
shared with the fitness kernel's plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.runtime import trace

# 32-bit words per leaf mask the CUDA kernel is instantiated for; must
# equal REPRO_NWP_CASES in csrc/tree_infer.cu (a test holds them equal).
# A leaf wider than the last (64 words, 2048 comparators) takes segments of
# it.
NWP_CHOICES = (4, 8, 12, 16, 20, 24, 28, 32, 48, 64)
PLAIN_CHUNK = 8  # chromosomes per step of the plain versions
# a block's dynamic shared memory on the H100; a decision tile that does not
# fit beside the votes goes to a global scratch buffer
SMEM_LIMIT = 232448
SAMPLES = 16     # samples per block (kSamples)


class PackedPath(NamedTuple):
    """The path as the kernel reads it: leaf l's +1 / -1 entries as bit
    masks of decision words ``word_off[l]`` onwards (bit k of mask word j is
    comparator 32 (word_off[l] + j) + k), ``n_seg`` segments of ``nwp``
    words each; ``d_words`` words of decisions a sample cover every mask."""

    pos: torch.Tensor       # (L, n_seg * nwp) int32
    neg: torch.Tensor       # (L, n_seg * nwp) int32
    word_off: torch.Tensor  # (L,) int32, multiples of 4
    nwp: int
    n_seg: int
    d_words: int


def pack_path(path: torch.Tensor) -> PackedPath:
    """(L, N) int8 path in {-1, 0, 1} -> its `PackedPath`: a leaf's masks
    start at the word of its first nonzero entry, rounded down to a multiple
    of 4 (16-byte loads), and are as wide as the widest leaf's span needs:
    the smallest of `NWP_CHOICES`, or segments of the largest past it. A
    forest's leaf spans only its own tree, so the width follows the widest
    tree, not N."""
    n_leaves, n = path.shape
    w_all = max(1, -(-n // 32))
    bit = torch.arange(32, device=path.device, dtype=torch.int64)

    def full(mask):
        padded = torch.zeros((n_leaves, w_all * 32), dtype=torch.int64,
                             device=path.device)
        padded[:, :n] = mask.to(torch.int64)
        return (padded.view(n_leaves, w_all, 32) << bit).sum(-1)

    pos_all, neg_all = full(path == 1), full(path == -1)
    live = (pos_all | neg_all) != 0
    col = torch.arange(w_all, device=path.device)
    first = torch.where(live, col, w_all).amin(1) if n_leaves else col[:0]
    last = torch.where(live, col, -1).amax(1) if n_leaves else col[:0]
    any_live = live.any(1)
    off = torch.where(any_live, first // 4 * 4, 0)
    need = int(torch.where(any_live, last - off + 1, 1).max()) if n_leaves else 1
    nwp = next((w for w in NWP_CHOICES if w >= need), NWP_CHOICES[-1])
    n_seg = -(-need // nwp)
    width = n_seg * nwp
    idx = off[:, None] + torch.arange(width, device=path.device)[None]
    inside = idx < w_all
    idx = idx.clamp_max(w_all - 1)

    def window(masks):
        w = torch.where(inside, torch.gather(masks, 1, idx), 0)
        return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)

    d_words = int(off.max()) + width if n_leaves else width
    return PackedPath(window(pos_all).contiguous(),
                      window(neg_all).contiguous(),
                      off.to(torch.int32).contiguous(), nwp, n_seg, d_words)


@dataclasses.dataclass
class TreeOperands:
    """Static operands of `tree_infer_scores` for one tree or forest layout
    (masks as `pack_path` packs them)."""

    feature: torch.Tensor     # (N,) int32 feature read by each comparator
    path: torch.Tensor        # (L, N) int8 in {-1, 0, 1} (plain version)
    pos: torch.Tensor         # (L, n_seg * nwp) int32 bit masks of +1 entries
    neg: torch.Tensor         # (L, n_seg * nwp) int32 bit masks of -1 entries
    word_off: torch.Tensor    # (L,) int32 first decision word of each mask
    target: torch.Tensor      # (L,) int32 score of a satisfied leaf
    leaf_class: torch.Tensor  # (L,) int32 in [0, n_classes)
    n_classes: int
    n_features: int
    nwp: int                  # mask words a segment (an instantiated width)
    n_seg: int                # segments a leaf
    d_words: int              # decision words a sample

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
    ``launches.tree_infer_scores``."""
    if not _build.on_cuda(x8, "tree_infer_scores"):
        return tree_infer_scores_plain(x8, ops, shift, thr)
    dev = x8.device
    n_pop, n = shift.shape
    batch = x8.shape[0]
    n_leaves = ops.pos.shape[0]
    width = ops.n_seg * ops.nwp
    _build.require(x8, "x8", torch.int32, dev, (batch, ops.n_features))
    for name, t in (("shift", shift), ("thr", thr)):
        _build.require(t, name, torch.int32, dev, (n_pop, n))
    _build.require(ops.feature, "feature", torch.int32, dev, (n,))
    if (ops.nwp not in NWP_CHOICES or (ops.n_seg > 1
                                       and ops.nwp != NWP_CHOICES[-1])
            or ops.d_words % 4):
        raise ValueError(f"mask layout nwp={ops.nwp} n_seg={ops.n_seg} "
                         f"d_words={ops.d_words} is not one the kernel "
                         f"takes")
    for name in ("pos", "neg"):
        _build.require(getattr(ops, name), name, torch.int32, dev,
                       (n_leaves, width))
        if getattr(ops, name).data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    for name in ("word_off", "target", "leaf_class"):
        _build.require(getattr(ops, name), name, torch.int32, dev, (n_leaves,))
    votes = torch.empty((n_pop, batch, ops.n_classes), dtype=torch.int32,
                        device=dev)
    if n_pop == 0 or batch == 0 or ops.n_classes == 0:
        return votes
    scratch = None
    if 4 * SAMPLES * (ops.d_words + ops.n_classes) > SMEM_LIMIT:
        blocks = -(-batch // SAMPLES) * n_pop
        scratch = torch.empty((blocks * SAMPLES * ops.d_words,),
                              dtype=torch.int32, device=dev)
    fn = _build.function("tree_infer", "repro_tree_infer_scores", 11, 9)
    rc = fn(_build.ptr(x8), _build.ptr(ops.feature), _build.ptr(shift),
            _build.ptr(thr), _build.ptr(ops.pos), _build.ptr(ops.neg),
            _build.ptr(ops.word_off), _build.ptr(ops.target),
            _build.ptr(ops.leaf_class), _build.ptr(votes),
            ctypes.c_void_p(None if scratch is None else scratch.data_ptr()),
            n_pop, batch, ops.n_features, n, n_leaves, ops.n_classes,
            ops.nwp, ops.n_seg, ops.d_words, _build.stream(dev))
    _build.check_launch(rc, "tree_infer_scores")
    trace.count("launches.tree_infer_scores")
    return votes


