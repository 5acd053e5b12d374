"""Bespoke-comparator and printed-MLP area models, Area LUT and power model.

A copy of the tree, forest and printed-MLP parts of `repro.core.area`
(numpy, host side). Hard-wired unsigned greater-than ``X > t`` is ``X >= u`` with
``u = t + 1``: bits below the lowest set bit of u are free, the lowest set
bit is a free wire, and every higher bit adds one 2-input gate (AND2 where
u_i = 1, OR2 where u_i = 0); ``u = 2^p`` is constant false. So
gates(t, p) = p - 1 - tz(t + 1).

Every gate area is an integer number of AREA_QUANTUM_MM2 quanta. The port
scores the area objective in those integer quanta (`build_area_unit_lut`),
which is exact under any summation order on any device.
"""
from __future__ import annotations

import functools

import numpy as np

from repro_torch.core.quant import MAX_BITS

AREA_AND2_MM2 = 0.55     # printed EGT 2-input gate
AREA_OR2_MM2 = 0.57
AREA_NOT_MM2 = 0.28      # inverter: ~half a 2-input EGT gate
AREA_XOR2_MM2 = 0.83     # 2-input XOR: ~1.5x AND2

AREA_QUANTUM_MM2 = 0.01
_AND2_UNITS = round(AREA_AND2_MM2 / AREA_QUANTUM_MM2)
_OR2_UNITS = round(AREA_OR2_MM2 / AREA_QUANTUM_MM2)
assert abs(_AND2_UNITS * AREA_QUANTUM_MM2 - AREA_AND2_MM2) < 1e-12
assert abs(_OR2_UNITS * AREA_QUANTUM_MM2 - AREA_OR2_MM2) < 1e-12
NODE_OVERHEAD_MM2 = 0.02  # per internal node: routing + decision buffering
LEAF_OVERHEAD_MM2 = 0.04  # per leaf: path-AND + class mux contribution
NODE_OVERHEAD_UNITS = round(NODE_OVERHEAD_MM2 / AREA_QUANTUM_MM2)
LEAF_OVERHEAD_UNITS = round(LEAF_OVERHEAD_MM2 / AREA_QUANTUM_MM2)
assert abs(NODE_OVERHEAD_UNITS * AREA_QUANTUM_MM2 - NODE_OVERHEAD_MM2) < 1e-12
assert abs(LEAF_OVERHEAD_UNITS * AREA_QUANTUM_MM2 - LEAF_OVERHEAD_MM2) < 1e-12
POWER_PER_MM2_MW = 0.0455  # paper Table I slope (mW per mm^2)
DELAY_BASE_MS = 19.2       # paper Table I affine fit (reported for completeness)
DELAY_PER_COMP_MS = 0.11


def comparator_gate_counts(t: int, p: int) -> tuple[int, int]:
    """(n_and2, n_or2) for hard-wired ``X > t`` with p-bit unsigned X."""
    u = t + 1
    if u >= (1 << p):
        return 0, 0
    tz = (u & -u).bit_length() - 1  # trailing zeros
    n_and = bin(u >> (tz + 1)).count("1")            # set bits above lowest
    n_or = (p - 1 - tz) - n_and                      # clear bits above lowest
    return n_and, n_or


def comparator_area_mm2(t: int, p: int) -> float:
    n_and, n_or = comparator_gate_counts(t, p)
    return n_and * AREA_AND2_MM2 + n_or * AREA_OR2_MM2


def comparator_area_units(t: int, p: int) -> int:
    """Comparator area as an exact integer count of AREA_QUANTUM_MM2 quanta."""
    n_and, n_or = comparator_gate_counts(t, p)
    return n_and * _AND2_UNITS + n_or * _OR2_UNITS


def trunc_comparator_gate_counts(t: int, p: int, k: int) -> tuple[int, int]:
    """(n_and2, n_or2) for a k-LSB-truncated p-bit comparator: the exact
    comparator of width p - k against t >> k; zero gates (constant false)
    when p - k <= 0."""
    if k >= p:
        return 0, 0
    return comparator_gate_counts(t >> k, p - k)


def trunc_comparator_area_mm2(t: int, p: int, k: int) -> float:
    n_and, n_or = trunc_comparator_gate_counts(t, p, k)
    return n_and * AREA_AND2_MM2 + n_or * AREA_OR2_MM2


def _build_lut(cell) -> tuple[np.ndarray, np.ndarray]:
    offsets = np.zeros(MAX_BITS + 1, dtype=np.int32)
    chunks = []
    pos = 0
    for p in range(0, MAX_BITS + 1):
        offsets[p] = pos
        chunks.append(np.array([cell(t, p) for t in range(1 << p)],
                               dtype=np.float32))
        pos += 1 << p
    return np.concatenate(chunks).astype(np.float32), offsets


def build_area_lut() -> tuple[np.ndarray, np.ndarray]:
    """Exhaustive LUT over p in [0, MAX_BITS], t in [0, 2^p).

    Returns (lut, offsets): lut float32[sum 2^p] of comparator areas (mm^2),
    offsets int32[MAX_BITS+1] with precision p's row at lut[offsets[p] + t].
    Rows below MIN_BITS exist because LSB truncation shrinks a comparator's
    effective width down to 0 (the constant-false comparator).
    """
    return _build_lut(comparator_area_mm2)


def build_area_unit_lut() -> tuple[np.ndarray, np.ndarray]:
    """Integer-quanta twin of `build_area_lut` (same indexing scheme);
    `lut_units * AREA_QUANTUM_MM2` recovers mm^2."""
    return _build_lut(comparator_area_units)


# --- forest vote-adder cells -------------------------------------------------
# The vote stage of a K-tree forest is priced from the netlist it lowers to:
# an isolated vote-stage harness (popcount adders and the first-max argmax
# chain for the exact adder, a saturating OR per class and a 1-bit argmax
# for the approximate one), built once per (n_trees, n_classes, mode) and
# inventoried in whole quanta.


@functools.lru_cache(maxsize=None)
def vote_adder_units(n_trees: int, n_classes: int, approx: bool) -> int:
    """Vote-adder area in exact AREA_QUANTUM_MM2 quanta; 0 for a single
    tree (its one-hot class needs no adder in either mode, so the vote gene
    is inert there)."""
    if n_trees <= 1:
        return 0
    from repro_torch.core import netlist
    counts = netlist.vote_adder_gate_counts(n_trees, n_classes, approx=approx)
    units = gate_area_mm2(*counts) / AREA_QUANTUM_MM2
    iunits = round(units)
    assert abs(iunits - units) < 1e-6
    return iunits


def vote_adder_area_mm2(n_trees: int, n_classes: int, approx: bool) -> float:
    return vote_adder_units(n_trees, n_classes, approx) * AREA_QUANTUM_MM2


# --- printed-MLP MAC / activation cells --------------------------------------
# A MAC term is lowered as shifted-copy rows through ripple full adders (the
# netlist's `full_add`: 2 XOR2 + 2 AND2 + 1 OR2); a negative weight costs one
# extra adder row. The activation cell (ReLU zero-mux or argmax compare leg)
# is priced per accumulator bit: XOR2 + 2 AND2 + OR2 + NOT. Every constant is
# a whole number of AREA_QUANTUM_MM2 quanta, so MLP areas sum exactly.
AREA_FA_MM2 = 2 * AREA_XOR2_MM2 + 2 * AREA_AND2_MM2 + AREA_OR2_MM2
AREA_ACT_BIT_MM2 = AREA_XOR2_MM2 + 2 * AREA_AND2_MM2 + AREA_OR2_MM2 + AREA_NOT_MM2
_FA_UNITS = round(AREA_FA_MM2 / AREA_QUANTUM_MM2)
_ACT_BIT_UNITS = round(AREA_ACT_BIT_MM2 / AREA_QUANTUM_MM2)
assert abs(_FA_UNITS * AREA_QUANTUM_MM2 - AREA_FA_MM2) < 1e-9
assert abs(_ACT_BIT_UNITS * AREA_QUANTUM_MM2 - AREA_ACT_BIT_MM2) < 1e-9


def mac_area_units(code: int, in_bits: int) -> int:
    """One integer-weight MAC term in quanta: each set bit of |code| is one
    shifted-copy row of ``in_bits`` full adders, a negative weight adds one
    subtractor row, and a zero weight is a free wire."""
    c = int(code)
    if c == 0:
        return 0
    rows = bin(abs(c)).count("1") + (1 if c < 0 else 0)
    return rows * int(in_bits) * _FA_UNITS


def mac_area_mm2(code: int, in_bits: int) -> float:
    return mac_area_units(code, in_bits) * AREA_QUANTUM_MM2


def act_area_units(acc_bits: int) -> int:
    """Activation cell (ReLU zero-mux or argmax compare leg) in quanta."""
    return int(acc_bits) * _ACT_BIT_UNITS


def act_area_mm2(acc_bits: int) -> float:
    return act_area_units(acc_bits) * AREA_QUANTUM_MM2


def mlp_neuron_area_units(codes, in_bits: int, acc_bits: int) -> int:
    """Area of one printed-MLP neuron in quanta: its MAC terms + one
    activation cell."""
    codes = np.asarray(codes).ravel()
    return (sum(mac_area_units(int(c), in_bits) for c in codes.tolist())
            + act_area_units(acc_bits))


def gate_area_mm2(n_and: int = 0, n_or: int = 0, n_not: int = 0,
                  n_xor: int = 0) -> float:
    """Area of an explicit gate inventory (the netlist oracle)."""
    return (n_and * AREA_AND2_MM2 + n_or * AREA_OR2_MM2
            + n_not * AREA_NOT_MM2 + n_xor * AREA_XOR2_MM2)


def tree_overhead_mm2(n_comparators: int, n_leaves: int) -> float:
    return n_comparators * NODE_OVERHEAD_MM2 + n_leaves * LEAF_OVERHEAD_MM2


def tree_area_mm2(features, t_ints, bits, n_leaves: int,
                  dedup: bool = False) -> float:
    """Total bespoke-tree (or forest) area: the additive LUT sum (the
    search's estimate) or, with ``dedup``, one comparator per distinct
    (feature, threshold, precision), shared as synthesis shares it; plus
    the per-node and per-leaf overheads."""
    features = np.asarray(features)
    t_ints = np.asarray(t_ints)
    bits = np.asarray(bits)
    if dedup:
        seen = {}
        for f, t, p in zip(features.tolist(), t_ints.tolist(), bits.tolist()):
            seen[(f, t, p)] = comparator_area_mm2(int(t), int(p))
        comp_area = sum(seen.values())
    else:
        comp_area = sum(comparator_area_mm2(int(t), int(p))
                        for t, p in zip(t_ints.tolist(), bits.tolist()))
    return comp_area + tree_overhead_mm2(len(features), n_leaves)


def tree_overhead_units(n_comparators: int, n_leaves: int) -> int:
    """`tree_overhead_mm2` in exact integer quanta."""
    return n_comparators * NODE_OVERHEAD_UNITS + n_leaves * LEAF_OVERHEAD_UNITS


def power_mw(area_mm2: float) -> float:
    return POWER_PER_MM2_MW * area_mm2


def delay_ms(n_comparators: int) -> float:
    return DELAY_BASE_MS + DELAY_PER_COMP_MS * n_comparators
