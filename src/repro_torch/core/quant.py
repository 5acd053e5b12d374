"""Threshold precision-conversion module on torch int32 tensors.

Semantics (all integer, derived from the [0,1]-normalized reals), as in
`repro.core.quant`:

  master code     x8 = floor(x * 2^8)            in [0, 255]
  input @ p bits  x_p = x8 >> (8 - p)            (truncation)
  thr fixed       t_p = floor(T * 2^p)           in [0, 2^p - 1]
  substitution    t'_p = clip(t_p + m, 0, 2^p-1) with margin m in [-5, 5]
  comparator      decision = (x_p > t'_p)        -> go right

Genes are float32 tensors in [0, 1]; every decode is a float32 multiply and
floor, the same IEEE operations the JAX package performs, so decoded
integers are identical.
"""
from __future__ import annotations

import numpy as np
import torch

MASTER_BITS = 8
MIN_BITS = 2
MAX_BITS = 8
MARGIN = 5  # threshold substitution margin m in [-5, +5]
MAX_TRUNC = 2  # per-comparator LSB truncation depth k in [0, MAX_TRUNC]
VOTE_ADDER_MODES = ("exact", "approx")
# Integer vote cap of the exact adder: no vote count reaches it, so clipping
# to it is a no-op (the JAX package's float +inf cap). The approximate
# OR-tree adder caps every class at 1.
NO_VOTE_CAP = 2 ** 31 - 1


def threshold_to_int(threshold: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """float T in (0,1) -> fixed-point integer code at ``bits`` precision."""
    b = bits.to(torch.int32)
    t = torch.floor(threshold * torch.exp2(b.to(torch.float32))).to(torch.int32)
    return torch.minimum(t.clamp_min(0), (torch.ones_like(b) << b) - 1)


def substitute(t_int: torch.Tensor, margin: torch.Tensor,
               bits: torch.Tensor) -> torch.Tensor:
    """Area-driven substitution: move the integer threshold by ``margin``."""
    b = bits.to(torch.int32)
    hi = (torch.ones_like(b) << b) - 1
    return torch.minimum((t_int + margin).clamp_min(0), hi)


def inputs_at_precision(x8: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Right-shift master 8-bit codes (..., N) down to per-comparator
    precision ``bits`` (N,) or broadcastable."""
    shift = (MASTER_BITS - bits).to(torch.int32)
    return x8.to(torch.int32) >> shift


def decode_tree_genes(genes: torch.Tensor):
    """Cross-layer tree genes [0,1]^(3N+1) -> (bits, margin, trunc, vote).

    Per comparator k, gene 3k is the precision, 3k+1 the substitution
    margin, 3k+2 the LSB-truncation depth; the final gene selects the vote
    adder (0 exact, 1 approximate). Returns int32 tensors.
    """
    g = genes.to(torch.float32)
    comp = g[..., :-1]
    gp, gm, gt = comp[..., 0::3], comp[..., 1::3], comp[..., 2::3]
    span_p = MAX_BITS - MIN_BITS + 1
    bits = MIN_BITS + torch.clamp(torch.floor(gp * span_p), 0, span_p - 1)
    margin = -MARGIN + torch.clamp(torch.floor(gm * (2 * MARGIN + 1)),
                                   0, 2 * MARGIN)
    span_t = MAX_TRUNC + 1
    trunc = torch.clamp(torch.floor(gt * span_t), 0, span_t - 1)
    vote = torch.clamp(torch.floor(g[..., -1] * 2), 0, 1)
    return (bits.to(torch.int32), margin.to(torch.int32),
            trunc.to(torch.int32), vote.to(torch.int32))


def vote_cap_of(vote: torch.Tensor) -> torch.Tensor:
    """int32 vote cap from the decoded vote gene: 1 (approximate adder)
    or NO_VOTE_CAP (exact adder)."""
    return torch.where(vote > 0, 1, NO_VOTE_CAP).to(torch.int32)


def exact_tree_genes(n_comparators: int) -> np.ndarray:
    """Chromosome for the exact design: 8 bits, zero margin, zero
    truncation, exact vote adder."""
    g = np.zeros(3 * n_comparators + 1, dtype=np.float32)
    g[0:-1:3] = 0.999  # precision -> 8 bits
    g[1:-1:3] = 0.5    # margin -> 0
    return g
