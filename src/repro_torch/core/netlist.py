"""Gate-level netlist IR of bespoke trees and printed MLPs, simulated on
torch.

The counterpart of `repro.core.netlist`. A tree or forest plus a decoded
chromosome (per-comparator precision and substituted integer threshold)
lowers to 2-input printed gates:

  comparator cells  hard-wired ``X > t'`` chains, one AND2/OR2 per
                    significant bit above the lowest set bit of ``t' + 1``
                    (the construction `core.area.comparator_gate_counts`
                    prices);
  path-AND cells    one AND tree per leaf over comparator literals;
  class-OR cells    per-class vote wires, binary-encoded into the class
                    (one tree) or counted by the forest's vote adders
                    (popcount or saturating OR) and a first-max argmax.

An integer-weight MLP lowers to shifted-copy MAC rows summed by ripple
adders, a ReLU cell per hidden neuron and a first-max argmax chain over the
output neurons (`build_mlp_circuit`).

Construction is hash-consed (structural CSE) with constant folding, and
builds on the host; gate ids and arrays come out identical to the JAX
package's. `simulate` evaluates the finished circuit over a batch of
samples on the samples' device, one gather and one boolean op per logic
level; it is the hardware oracle `--verify-rtl` and the server are held to.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import area as area_mod
from repro_torch.core.tree import ParallelTree

# gate opcodes; CONST0/CONST1 are always gates 0 and 1 of every netlist
CONST0, CONST1, INPUT, NOT, AND, OR, XOR = range(7)
OP_NAMES = ("const0", "const1", "input", "not", "and", "or", "xor")
MASTER_BITS = 8


class NetlistBuilder:
    """Hash-consed gate builder with constant folding.

    Gate ids are topologically ordered by construction (operands always
    precede their gate), so a single linear pass levelizes the netlist.
    """

    def __init__(self):
        self.op: list[int] = []
        self.a: list[int] = []
        self.b: list[int] = []
        self._cache: dict[tuple[int, int, int], int] = {}
        self.zero = self._raw(CONST0, -1, -1)   # gate 0
        self.one = self._raw(CONST1, -1, -1)    # gate 1

    def _raw(self, op: int, a: int, b: int) -> int:
        key = (op, a, b)
        gid = self._cache.get(key)
        if gid is None:
            gid = len(self.op)
            self.op.append(op)
            self.a.append(a)
            self.b.append(b)
            self._cache[key] = gid
        return gid

    def input_bit(self, feature: int, bit: int) -> int:
        """Bit `bit` (LSB = 0) of feature `feature`'s 8-bit master code."""
        return self._raw(INPUT, int(feature), int(bit))

    def not_(self, x: int) -> int:
        if x == self.zero:
            return self.one
        if x == self.one:
            return self.zero
        if self.op[x] == NOT:           # ~~x = x
            return self.a[x]
        return self._raw(NOT, x, -1)

    def _is_complement(self, x: int, y: int) -> bool:
        return (self.op[y] == NOT and self.a[y] == x) or (
            self.op[x] == NOT and self.a[x] == y)

    def and_(self, x: int, y: int) -> int:
        if x == y:
            return x
        if x == self.zero or y == self.zero:
            return self.zero
        if x == self.one:
            return y
        if y == self.one:
            return x
        if self._is_complement(x, y):
            return self.zero
        if x > y:                       # commutative normal form
            x, y = y, x
        return self._raw(AND, x, y)

    def or_(self, x: int, y: int) -> int:
        if x == y:
            return x
        if x == self.one or y == self.one:
            return self.one
        if x == self.zero:
            return y
        if y == self.zero:
            return x
        if self._is_complement(x, y):
            return self.one
        if x > y:
            x, y = y, x
        return self._raw(OR, x, y)

    def xor_(self, x: int, y: int) -> int:
        if x == y:
            return self.zero
        if x == self.zero:
            return y
        if y == self.zero:
            return x
        if x == self.one:
            return self.not_(y)
        if y == self.one:
            return self.not_(x)
        if self._is_complement(x, y):
            return self.one
        if x > y:
            x, y = y, x
        return self._raw(XOR, x, y)

    def _reduce(self, wires: list[int], fn) -> int:
        """Balanced binary reduction (minimizes logic depth/sim levels)."""
        if not wires:
            raise ValueError("empty reduction")
        while len(wires) > 1:
            nxt = [fn(wires[i], wires[i + 1])
                   for i in range(0, len(wires) - 1, 2)]
            if len(wires) % 2:
                nxt.append(wires[-1])
            wires = nxt
        return wires[0]

    def and_many(self, wires: list[int]) -> int:
        return self._reduce(list(wires), self.and_) if wires else self.one

    def or_many(self, wires: list[int]) -> int:
        return self._reduce(list(wires), self.or_) if wires else self.zero

    def comparator(self, feature: int, t_int: int, p: int) -> int:
        """Hard-wired ``X > t'`` where X is the top `p` master-code bits:
        ``X >= u`` with ``u = t' + 1``; the lowest set bit of u is a free
        wire and every higher bit one gate (u_i = 1 -> AND, 0 -> OR);
        ``u = 2^p`` is constant false."""
        u = int(t_int) + 1
        if u >= (1 << p):
            return self.zero
        tz = (u & -u).bit_length() - 1          # trailing zeros of u
        # truncated bit j of X is master bit (8 - p + j)
        g = self.input_bit(feature, MASTER_BITS - p + tz)
        for i in range(tz + 1, p):
            xi = self.input_bit(feature, MASTER_BITS - p + i)
            g = self.and_(xi, g) if (u >> i) & 1 else self.or_(xi, g)
        return g

    # -- arithmetic over LSB-first bit vectors (MLP MACs and argmax) -------
    def _pad(self, a_bits: list[int], b_bits: list[int]):
        n = max(len(a_bits), len(b_bits))
        return (list(a_bits) + [self.zero] * (n - len(a_bits)),
                list(b_bits) + [self.zero] * (n - len(b_bits)))

    def full_add(self, x: int, y: int, c: int) -> tuple[int, int]:
        s1 = self.xor_(x, y)
        return self.xor_(s1, c), self.or_(self.and_(x, y), self.and_(s1, c))

    def add(self, a_bits: list[int], b_bits: list[int]) -> list[int]:
        """Ripple-carry add; the result keeps the carry out, so sums never
        wrap."""
        a_bits, b_bits = self._pad(a_bits, b_bits)
        out, carry = [], self.zero
        for x, y in zip(a_bits, b_bits):
            s, carry = self.full_add(x, y, carry)
            out.append(s)
        out.append(carry)
        return out

    def popcount(self, wires: list[int]) -> list[int]:
        """LSB-first bit-vector count of set wires (balanced adder tree)."""
        if not wires:
            return [self.zero]
        vecs = [[w] for w in wires]
        while len(vecs) > 1:
            nxt = [self.add(vecs[i], vecs[i + 1])
                   for i in range(0, len(vecs) - 1, 2)]
            if len(vecs) % 2:
                nxt.append(vecs[-1])
            vecs = nxt
        return vecs[0]

    def gt(self, a_bits: list[int], b_bits: list[int]) -> int:
        """Unsigned a > b."""
        a_bits, b_bits = self._pad(a_bits, b_bits)
        g = self.zero
        for x, y in zip(a_bits, b_bits):        # LSB -> MSB
            gt_i = self.and_(x, self.not_(y))
            eq_i = self.not_(self.xor_(x, y))
            g = self.or_(gt_i, self.and_(eq_i, g))
        return g

    def mux_vec(self, sel: int, a_bits: list[int],
                b_bits: list[int]) -> list[int]:
        """sel ? a : b, bitwise."""
        a_bits, b_bits = self._pad(a_bits, b_bits)
        ns = self.not_(sel)
        return [self.or_(self.and_(sel, x), self.and_(ns, y))
                for x, y in zip(a_bits, b_bits)]

    def const_vec(self, value: int, width: int) -> list[int]:
        return [self.one if (value >> i) & 1 else self.zero
                for i in range(width)]

    def sub(self, a_bits: list[int], b_bits: list[int]) -> list[int]:
        """Unsigned a - b as ``a + ~b + 1``, carry out dropped: right only
        when a >= b, so callers select it behind a `gt` (the ReLU cell)."""
        a_bits, b_bits = self._pad(a_bits, b_bits)
        out, carry = [], self.one          # the +1 of the two's complement
        for x, y in zip(a_bits, b_bits):
            s, carry = self.full_add(x, self.not_(y), carry)
            out.append(s)
        return out

    def sum_vecs(self, vecs: list) -> list[int]:
        """Balanced adder tree over bit vectors (the MAC accumulate)."""
        if not vecs:
            return [self.zero]
        vecs = [list(v) for v in vecs]
        while len(vecs) > 1:
            nxt = [self.add(vecs[i], vecs[i + 1])
                   for i in range(0, len(vecs) - 1, 2)]
            if len(vecs) % 2:
                nxt.append(vecs[-1])
            vecs = nxt
        return vecs[0]


@dataclasses.dataclass
class ComparatorCell:
    """One lowered comparator; `bits`/`t_int` are the EFFECTIVE width and
    substituted threshold ((p - k, t' >> k) for a k-truncated cell)."""

    feature: int
    bits: int
    t_int: int      # SUBSTITUTED integer threshold t' (effective)
    wire: int       # == 0 (CONST0) when t' = 2^p - 1 folds the cell away
    trunc: int = 0  # LSB stages dropped from the requested-width cell


@dataclasses.dataclass
class LeafCell:
    literals: list  # [(comparator index, positive: bool), ...]
    leaf_class: int
    wire: int


@dataclasses.dataclass
class TreeCells:
    comparators: list  # [ComparatorCell]
    leaves: list       # [LeafCell]
    votes: list        # per-class one-hot vote wires (OR of own leaves)


@dataclasses.dataclass
class Circuit:
    """A finished netlist: frozen gate arrays + the cell structure."""

    op: np.ndarray        # int8[G]
    a: np.ndarray         # int32[G]
    b: np.ndarray         # int32[G]
    out_bits: tuple       # class-index wires, LSB first
    trees: list           # [TreeCells], or [MlpCells] for an MLP
    n_classes: int

    @property
    def n_gates(self) -> int:
        return int(self.op.shape[0])

    @property
    def n_trees(self) -> int:
        return len(self.trees)


def class_bits(n_classes: int) -> int:
    return max(1, int(np.ceil(np.log2(max(n_classes, 2)))))


def build_tree_cells(nb: NetlistBuilder, pt: ParallelTree, bits, t_int,
                     n_classes: int, trunc=None) -> TreeCells:
    """Lower one tree's comparators/leaves/votes into the shared builder;
    `trunc` drops the k lowest stages of each comparator chain."""
    bits = np.asarray(bits)
    t_int = np.asarray(t_int)
    trunc = (np.zeros_like(bits) if trunc is None else np.asarray(trunc))
    comps = []
    for c in range(pt.n_comparators):
        k = int(trunc[c])
        p_eff = max(int(bits[c]) - k, 0)
        t_eff = int(t_int[c]) >> k
        comps.append(ComparatorCell(
            int(pt.feature[c]), p_eff, t_eff,
            nb.comparator(int(pt.feature[c]), t_eff, p_eff), trunc=k))
    leaves = []
    for l in range(pt.n_leaves):
        lits = [(c, int(pt.path[l, c]) == 1)
                for c in range(pt.n_comparators) if int(pt.path[l, c]) != 0]
        wire = nb.and_many(
            [comps[c].wire if pos else nb.not_(comps[c].wire)
             for c, pos in lits])
        leaves.append(LeafCell(lits, int(pt.leaf_class[l]), wire))
    votes = [nb.or_many([lf.wire for lf in leaves if lf.leaf_class == c])
             for c in range(n_classes)]
    return TreeCells(comps, leaves, votes)


def build_circuit(ptrees, bits, t_int, n_classes: int, trunc=None,
                  vote_adder: str = "exact") -> Circuit:
    """Tree or forest + decoded chromosome -> verified-hardware netlist.

    ``bits``/``t_int``/``trunc`` are concatenated per-comparator arrays over
    the K trees (the `SearchProblem` chromosome layout). A single tree
    binary-encodes its one-hot class votes (exactly one leaf fires), so
    ``vote_adder`` is inert. K > 1 builds the vote stage ``vote_adder``
    selects: "exact" counts each class's votes with a popcount adder tree,
    "approx" saturates each class to the 1-bit OR of its votes; either way
    a first-max argmax chain picks the class, as `predict_votes`' argmax
    over (capped) vote counts does.
    """
    if vote_adder not in ("exact", "approx"):
        raise ValueError(f"unknown vote_adder {vote_adder!r}")
    if isinstance(ptrees, ParallelTree):
        ptrees = [ptrees]
    bits = np.asarray(bits)
    t_int = np.asarray(t_int)
    trunc = (np.zeros_like(bits) if trunc is None else np.asarray(trunc))
    nb = NetlistBuilder()
    trees, off = [], 0
    for pt in ptrees:
        n = pt.n_comparators
        trees.append(build_tree_cells(nb, pt, bits[off:off + n],
                                      t_int[off:off + n], n_classes,
                                      trunc=trunc[off:off + n]))
        off += n
    if off != bits.shape[0]:
        raise ValueError(
            f"chromosome covers {bits.shape[0]} comparators, trees have {off}")

    n_bits = class_bits(n_classes)
    if len(trees) == 1:
        # one-hot votes -> binary class index (exactly one leaf fires)
        out = [nb.or_many([trees[0].votes[c] for c in range(n_classes)
                           if (c >> b) & 1]) for b in range(n_bits)]
    else:
        out = _vote_argmax(nb, trees, n_classes, approx=vote_adder == "approx")
    return Circuit(
        op=np.asarray(nb.op, np.int8),
        a=np.asarray(nb.a, np.int32),
        b=np.asarray(nb.b, np.int32),
        out_bits=tuple(out[:n_bits]),
        trees=trees,
        n_classes=int(n_classes),
    )


def _vote_argmax(nb: NetlistBuilder, trees, n_classes: int,
                 approx: bool) -> list:
    """Forest vote stage: per-class counts (popcount adders, or in approx
    mode the 1-bit OR of the class's votes) and a first-max argmax chain."""
    n_bits = class_bits(n_classes)
    if approx:
        counts = [[nb.or_many([t.votes[c] for t in trees])]
                  for c in range(n_classes)]
    else:
        counts = [nb.popcount([t.votes[c] for t in trees])
                  for c in range(n_classes)]
    best_cnt, best_idx = counts[0], nb.const_vec(0, n_bits)
    for c in range(1, n_classes):
        sel = nb.gt(counts[c], best_cnt)
        best_cnt = nb.mux_vec(sel, counts[c], best_cnt)
        best_idx = nb.mux_vec(sel, nb.const_vec(c, n_bits), best_idx)
    return best_idx


def vote_adder_gate_counts(n_trees: int, n_classes: int,
                           approx: bool) -> tuple[int, int, int, int]:
    """(n_and, n_or, n_not, n_xor) of an isolated forest vote stage, built
    on free-standing input wires (one per tree and class): the inventory
    `core.area.vote_adder_units` prices, so the search's vote-adder quanta
    come from the lowering `build_circuit` emits. An isolated stage shares
    no logic with tree cells, so this is the pre-CSE estimate."""
    nb = NetlistBuilder()
    trees = [TreeCells([], [], [nb.input_bit(k, c) for c in range(n_classes)])
             for k in range(n_trees)]
    _vote_argmax(nb, trees, n_classes, approx=approx)
    op = np.asarray(nb.op)
    return (int((op == AND).sum()), int((op == OR).sum()),
            int((op == NOT).sum()), int((op == XOR).sum()))


@dataclasses.dataclass
class MacNeuronCell:
    """One integer-weight neuron: shifted-copy MAC rows + an activation.

    The signed accumulator is an unsigned (pos, neg) pair, positive and
    negative MAC terms summed apart, so no sign bit exists in hardware: ReLU
    is ``pos > neg ? pos - neg : 0`` and the argmax compares
    ``pos_c + neg_best`` against ``pos_best + neg_c``."""

    weights: list       # effective signed integer weights, one per input
    relu: bool          # hidden neurons apply ReLU + the static right shift
    pos: list           # unsigned positive-sum wires, LSB first
    neg: list           # unsigned negative-sum wires, LSB first
    out: list           # activation output wires (ReLU'd + shifted)


@dataclasses.dataclass
class MlpCells:
    hidden: list        # [MacNeuronCell], ReLU outputs feed the next layer
    outputs: list       # [MacNeuronCell], (pos, neg) pairs feed the argmax
    shift: int          # static right shift applied after every ReLU


def _mac_rows(nb: NetlistBuilder, in_vecs, weights):
    """A neuron's MAC terms as (positive, negative) shifted-copy rows: set
    bit s of |w| adds the input shifted left by s (s leading CONST0s, free
    wire), routed by the sign of w."""
    pos, neg = [], []
    for vec, w in zip(in_vecs, weights):
        w = int(w)
        if w == 0:
            continue
        dst = pos if w > 0 else neg
        mag, s = abs(w), 0
        while mag:
            if mag & 1:
                dst.append([nb.zero] * s + list(vec))
            mag >>= 1
            s += 1
    return pos, neg


def build_mac_neuron(nb: NetlistBuilder, in_vecs, weights, *,
                     relu: bool, shift: int = 0) -> MacNeuronCell:
    """Lower one integer-weight neuron into the shared builder."""
    pos_rows, neg_rows = _mac_rows(nb, in_vecs, weights)
    pos = nb.sum_vecs(pos_rows)
    neg = nb.sum_vecs(neg_rows)
    out = []
    if relu:
        # pos > neg ? pos - neg : 0 (the mux hides the wrapped pos < neg
        # case); the static right shift drops low bits, a free wire
        sel = nb.gt(pos, neg)
        diff = nb.mux_vec(sel, nb.sub(pos, neg),
                          [nb.zero] * max(len(pos), len(neg)))
        out = diff[shift:] if shift < len(diff) else [nb.zero]
    return MacNeuronCell([int(w) for w in weights], relu, pos, neg, out)


def build_mlp_circuit(w1, w2, shift: int, n_classes: int) -> Circuit:
    """Integer-weight MLP (one hidden ReLU layer) -> netlist.

    ``w1`` (F, H) and ``w2`` (H, C) are EFFECTIVE signed integer weights;
    ``shift`` is the static right shift after every ReLU; inputs are the
    8-bit master codes. The argmax chain scans classes in order and replaces
    the incumbent only on strictly greater, so ties go to the first maximum
    as `torch.argmax`'s do. Exact against the integer forward pass.
    """
    w1 = np.asarray(w1)
    w2 = np.asarray(w2)
    n_features, n_hidden = w1.shape
    if w2.shape != (n_hidden, n_classes):
        raise ValueError(f"w2 shape {w2.shape} != ({n_hidden}, {n_classes})")
    nb = NetlistBuilder()
    in_vecs = [[nb.input_bit(f, i) for i in range(MASTER_BITS)]
               for f in range(n_features)]
    hidden = [build_mac_neuron(nb, in_vecs, w1[:, j], relu=True, shift=shift)
              for j in range(n_hidden)]
    h_vecs = [cell.out for cell in hidden]
    outputs = [build_mac_neuron(nb, h_vecs, w2[:, c], relu=False)
               for c in range(n_classes)]

    n_bits = class_bits(n_classes)
    best_pos, best_neg = outputs[0].pos, outputs[0].neg
    best_idx = nb.const_vec(0, n_bits)
    for c in range(1, n_classes):
        # s_c > s_best  <=>  pos_c + neg_best > pos_best + neg_c  (unsigned)
        sel = nb.gt(nb.add(outputs[c].pos, best_neg),
                    nb.add(best_pos, outputs[c].neg))
        best_pos = nb.mux_vec(sel, outputs[c].pos, best_pos)
        best_neg = nb.mux_vec(sel, outputs[c].neg, best_neg)
        best_idx = nb.mux_vec(sel, nb.const_vec(c, n_bits), best_idx)
    return Circuit(
        op=np.asarray(nb.op, np.int8),
        a=np.asarray(nb.a, np.int32),
        b=np.asarray(nb.b, np.int32),
        out_bits=tuple(best_idx[:n_bits]),
        trees=[MlpCells(hidden, outputs, int(shift))],
        n_classes=int(n_classes),
    )


def levelize(circuit: Circuit) -> np.ndarray:
    """(G,) int32 logic level per gate (0 = inputs/constants)."""
    op, a, b = circuit.op, circuit.a, circuit.b
    level = np.zeros(circuit.n_gates, np.int32)
    for i in np.flatnonzero(op >= NOT):
        la = level[a[i]]
        lb = level[b[i]] if op[i] != NOT else 0
        level[i] = max(la, lb) + 1
    return level


def simulate(circuit: Circuit, x8) -> torch.Tensor:
    """(B,) int32 predicted class over (B, F) integer master codes, on the
    device of ``x8`` (a numpy array runs on the CPU).

    Gates are grouped by logic level and each level is one gather and one
    boolean op over all its gates at once.
    """
    op, a, b = circuit.op, circuit.a, circuit.b
    level = levelize(circuit)
    x8 = torch.as_tensor(x8).to(torch.int32)
    dev = x8.device
    n_b = x8.shape[0]
    vals = torch.zeros((n_b, circuit.n_gates), dtype=torch.bool, device=dev)

    def idx(arr):
        return torch.as_tensor(np.ascontiguousarray(arr), dtype=torch.int64,
                               device=dev)

    base = np.flatnonzero(level == 0)
    feat = idx(np.maximum(a[base], 0))
    bit = idx(np.maximum(b[base], 0)).to(torch.int32)
    in_vals = ((x8[:, feat] >> bit[None, :]) & 1).to(torch.bool)
    base_ops = idx(op[base])[None, :]
    vals[:, idx(base)] = torch.where(base_ops == INPUT, in_vals,
                                     base_ops == CONST1)

    for lvl in range(1, int(level.max()) + 1 if (op >= NOT).any() else 1):
        gates = np.flatnonzero(level == lvl)
        if gates.size == 0:
            continue
        av = vals[:, idx(a[gates])]
        bv = vals[:, idx(np.maximum(b[gates], 0))]
        ops = idx(op[gates])[None, :]
        out = torch.where(
            ops == NOT, ~av,
            torch.where(ops == AND, av & bv,
                        torch.where(ops == OR, av | bv, av ^ bv)))
        vals[:, idx(gates)] = out

    cls = torch.zeros((n_b,), dtype=torch.int32, device=dev)
    for i, w in enumerate(circuit.out_bits):
        cls = cls | (vals[:, w].to(torch.int32) << i)
    return cls


def gate_counts(circuit: Circuit) -> dict:
    """Logic-gate inventory after CSE/constant propagation."""
    ops, counts = np.unique(circuit.op, return_counts=True)
    by_name = {OP_NAMES[o]: int(c) for o, c in zip(ops, counts)}
    return {name: by_name.get(name, 0) for name in ("and", "or", "not", "xor")}


def netlist_area_mm2(circuit: Circuit) -> float:
    """Synthesized-netlist area: every gate priced, nothing estimated."""
    c = gate_counts(circuit)
    return area_mod.gate_area_mm2(n_and=c["and"], n_or=c["or"],
                                  n_not=c["not"], n_xor=c["xor"])
