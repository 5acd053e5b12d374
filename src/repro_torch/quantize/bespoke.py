"""The popcount snap table of `repro.quantize.bespoke` (numpy, host side).

Each integer code moves, within +/-margin, to the code with the cheapest
multiplier: the fewest set bits of |code|, ties to the smallest step. In a
bespoke printed MAC the cost of a constant multiplier tracks its set bits,
so this is the comparator threshold substitution carried over to MAC
weights. The printed-MLP family decodes every weight through it.
"""
from __future__ import annotations

import functools

import numpy as np


def _popcount(v: int) -> int:
    return bin(abs(v)).count("1")


@functools.lru_cache(maxsize=64)
def snap_lut(bits: int, margin: int) -> np.ndarray:
    """code (two's complement int in [-2^(b-1), 2^(b-1)-1]) -> snapped code,
    indexed by ``code - lo``.

    The single-step snap is chased to a FIXPOINT: one step can land on a
    code that itself snaps cheaper (bits=8, margin=2: 19 -> 18 -> 16), and
    re-snapping already snapped weights, as the printed-MLP decode does
    through its precision ladder, must not drift. The chase ends because
    each hop strictly lowers the (popcount, |step|) key; margin 0 is the
    identity and no code leaves [lo, hi]. The cached array is shared by
    every caller, so it is returned read-only.
    """
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    out = np.zeros(1 << bits, dtype=np.int32)
    for code in range(lo, hi + 1):
        best, best_key = code, (_popcount(code), 0)
        for d in range(-margin, margin + 1):
            c = code + d
            if c < lo or c > hi:
                continue
            key = (_popcount(c), abs(d))
            if key < best_key:
                best, best_key = c, key
        out[code - lo] = best
    for idx in range(out.shape[0]):
        for _ in range(out.shape[0]):
            nxt = int(out[int(out[idx]) - lo])
            if nxt == int(out[idx]):
                break
            out[idx] = nxt
    out.flags.writeable = False
    return out
