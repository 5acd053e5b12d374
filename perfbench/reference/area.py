"""The printed-gate area model, in whole quanta of 0.01 mm^2.

Gate areas of the printed EGT library: AND2 0.55, OR2 0.57, NOT 0.28, XOR2
0.83 mm^2. A hard-wired ``X > t`` on p bits is ``X >= t + 1``: bits below
the lowest set bit of u = t + 1 are free, that bit is a wire, and each bit
above it costs an AND2 (u_i = 1) or an OR2 (u_i = 0); u = 2^p is the
constant false. A tree adds 0.02 mm^2 per comparator and 0.04 per leaf.
A printed-MLP MAC term costs one row of ``in_bits`` full adders (2 XOR2,
2 AND2, 1 OR2) per set bit of |w|, plus a row for a negative w; an
activation cell costs XOR2 + 2 AND2 + OR2 + NOT per accumulator bit.
"""
from __future__ import annotations

import numpy as np

AND2, OR2, NOT1, XOR2 = 55, 57, 28, 83
NODE, LEAF = 2, 4
FULL_ADDER = 2 * XOR2 + 2 * AND2 + OR2
ACT_BIT = XOR2 + 2 * AND2 + OR2 + NOT1
MAX_BITS = 8


def comparator_units(t: int, p: int) -> int:
    u = t + 1
    if u >= 1 << p:
        return 0
    tz = (u & -u).bit_length() - 1
    n_and = bin(u >> (tz + 1)).count("1")
    return AND2 * n_and + OR2 * (p - 1 - tz - n_and)


def comparator_table() -> np.ndarray:
    """(9, 256) int64: [p, t] -> units of ``X > t`` on p bits (t < 2^p)."""
    table = np.zeros((MAX_BITS + 1, 1 << MAX_BITS), np.int64)
    for p in range(MAX_BITS + 1):
        for t in range(1 << p):
            table[p, t] = comparator_units(t, p)
    return table


def mac_units(w: int, in_bits: int) -> int:
    if w == 0:
        return 0
    return (bin(abs(w)).count("1") + (w < 0)) * in_bits * FULL_ADDER


def neuron_units(weights, in_bits: int, acc_bits: int) -> int:
    return (sum(mac_units(int(w), in_bits) for w in np.ravel(weights))
            + acc_bits * ACT_BIT)
