"""NSGA-II pairwise domination and the non-dominated sort: Hopper kernels
and plain versions.

Replaces the TPU kernel `repro/kernels/domination.py::domination_block`
(and `domination_matrix`, its square case): for minimised objectives,
``dom[i, j] = all(a_i <= b_j) & any(a_i < b_j)``; and the front peel that
`repro.core.nsga2.non_dominated_sort` runs on that matrix in a
`jax.lax.while_loop`. All kernels are in `csrc/domination.cu`, where their
bounds and designs are stated:

- `domination_block`: the (Pi, Pj) bool slab (ragged edges masked in the
  kernel, so no +inf padding).
- `domination_bits`: the square relation as bits, transposed: ``rel[w, j]``
  bit k says that row 32w + k dominates column j; with each column's
  dominator count.
- `non_dominated_rank`: the rank of every row (0 = first front):
  `domination_bits` and one peel launch, which peels every front on the card,
  so the sort makes no host round trip.

The sort's two wrappers also take a leading problem axis, objs (K, P, M):
the sweep sorts a bucket's K pools in the same two launches (one block of
the peel a pool), as the JAX package's vmap of the kernel adds a grid
axis; one pool is K = 1.

On a CPU tensor each wrapper runs its plain PyTorch version; on a CUDA
tensor it launches its kernel or raises. The plain version of the peel is
the host loop, one device query per front.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.runtime import trace


def domination_block_plain(objs_i: torch.Tensor,
                           objs_j: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `domination_block`."""
    a = objs_i[:, None, :]
    b = objs_j[None, :, :]
    return (a <= b).all(-1) & (a < b).any(-1)


def domination_block(objs_i: torch.Tensor,
                     objs_j: torch.Tensor) -> torch.Tensor:
    """(Pi, Pj) bool: row i dominates column j. objs_i (Pi, M) and objs_j
    (Pj, M) float32. Counts its kernel launches in
    ``launches.domination_block``."""
    if not _build.on_cuda(objs_i, "domination_block"):
        return domination_block_plain(objs_i, objs_j)
    dev = objs_i.device
    pi, m = objs_i.shape
    pj = objs_j.shape[0]
    _build.require(objs_i, "objs_i", torch.float32, dev)
    _build.require(objs_j, "objs_j", torch.float32, dev, (pj, m))
    dom = torch.empty((pi, pj), dtype=torch.bool, device=dev)
    if pi == 0 or pj == 0 or m == 0:
        return dom.fill_(False) if m == 0 else dom
    fn = _build.function("domination", "repro_domination_block", 3, 3)
    rc = fn(_build.ptr(objs_i), _build.ptr(objs_j), _build.ptr(dom), pi, pj, m,
            _build.stream(dev))
    _build.check_launch(rc, "domination_block")
    trace.count("launches.domination_block")
    return dom




def domination_matrix(objs: torch.Tensor) -> torch.Tensor:
    """(P, P) bool: the square case, one operand against itself."""
    return domination_block(objs, objs)


def relation_words(p: int) -> int:
    """32-bit words of one column of the packed relation."""
    return -(-p // 32)


def _per_pool(fn, objs: torch.Tensor):
    """``fn`` of each pool of objs (K, P, M), its outputs stacked."""
    outs = [fn(o) for o in objs]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*outs))
    return torch.stack(outs)


def domination_bits_plain(objs: torch.Tensor):
    """Plain PyTorch version of `domination_bits`: the same bits in the same
    layout."""
    if objs.dim() == 3:
        return _per_pool(domination_bits_plain, objs)
    p = objs.shape[0]
    dom = domination_block_plain(objs, objs)
    words = relation_words(p)
    padded = torch.zeros((words * 32, p), dtype=torch.int64,
                         device=objs.device)
    padded[:p] = dom
    bit = torch.arange(32, dtype=torch.int64, device=objs.device)
    w = (padded.view(words, 32, p) << bit[:, None]).sum(1)
    rel = torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)
    return rel, dom.sum(0, dtype=torch.int32)


def domination_bits(objs: torch.Tensor):
    """(rel, counts) of objs (P, M) float32: rel (W, P) int32 with
    W = `relation_words(P)`, bit k of ``rel[w, j]`` set iff row 32w + k
    dominates row j; counts (P,) int32 dominators of each row. For K pools,
    objs (K, P, M), rel (K, W, P) and counts (K, P), one launch. Counts its
    kernel launches in ``launches.domination_bits``."""
    if not _build.on_cuda(objs, "domination_bits"):
        return domination_bits_plain(objs)
    dev = objs.device
    *lead, p, m = objs.shape
    n_prob = lead[0] if lead else 1
    if len(lead) > 1 or n_prob > 65535:
        raise ValueError(f"objs {tuple(objs.shape)}: expected (P, M) or "
                         f"(K, P, M) with K <= 65535")
    _build.require(objs, "objs", torch.float32, dev)
    rel = torch.empty((*lead, relation_words(p), p), dtype=torch.int32,
                      device=dev)
    counts = torch.empty((*lead, p), dtype=torch.int32, device=dev)
    if p == 0 or m == 0 or n_prob == 0:
        return rel.zero_(), counts.zero_()
    fn = _build.function("domination", "repro_domination_bits", 3, 3)
    rc = fn(_build.ptr(objs), _build.ptr(rel), _build.ptr(counts), n_prob,
            p, m, _build.stream(dev))
    _build.check_launch(rc, "domination_bits")
    trace.count("launches.domination_bits")
    return rel, counts




def non_dominated_rank_plain(objs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `non_dominated_rank`: the host loop, which
    asks the device once per front whether any row is unranked (pool by
    pool for K pools)."""
    if objs.dim() == 3:
        return _per_pool(non_dominated_rank_plain, objs)
    dom = domination_block_plain(objs, objs)
    p = dom.shape[0]
    counts = dom.sum(0, dtype=torch.int32)        # how many dominate j
    rank = torch.full((p,), -1, dtype=torch.int32, device=dom.device)
    r = 0
    while p and bool((rank < 0).any()):           # one host sync per front
        current = (counts == 0) & (rank < 0)
        rank = torch.where(current, r, rank)
        # removing `current` decrements the dominator count of their dominatees
        dec = (dom & current[:, None]).sum(0, dtype=torch.int32)
        counts = torch.where(rank < 0, counts - dec, -1)
        r += 1
    return rank


def non_dominated_rank(objs: torch.Tensor) -> torch.Tensor:
    """(P,) int32 rank of each row of objs (P, M) float32, 0 = first front;
    (K, P) for K pools, objs (K, P, M). On the card: `domination_bits`,
    then one launch that peels every front of every pool (a block a pool),
    and no host sync. Counts the peel's launches in
    ``launches.non_dominated_rank``."""
    if not _build.on_cuda(objs, "non_dominated_rank"):
        return non_dominated_rank_plain(objs)
    dev = objs.device
    *lead, p, m = objs.shape
    n_prob = lead[0] if lead else 1
    _build.require(objs, "objs", torch.float32, dev)
    if p == 0 or m == 0 or n_prob == 0:   # no row dominates another
        return torch.zeros((*lead, p), dtype=torch.int32, device=dev)
    rel, counts = domination_bits(objs)
    rank = torch.empty((*lead, p), dtype=torch.int32, device=dev)
    fn = _build.function("domination", "repro_peel_fronts", 3, 2)
    rc = fn(_build.ptr(rel), _build.ptr(counts), _build.ptr(rank), n_prob, p,
            _build.stream(dev))
    _build.check_launch(rc, "non_dominated_rank")
    trace.count("launches.non_dominated_rank")
    return rank


