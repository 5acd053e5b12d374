"""Bespoke RTL (Verilog) emission for single trees and finished netlists.

A copy of the single-tree path and of `emit_circuit_verilog` of
`repro.core.rtl`: a tree is lowered to the gate-level netlist IR
(`core.netlist`) and the Verilog is printed from its cells; any other
circuit (the printed MLP) is printed gate by gate. Either way
`netlist.simulate` is the emitted module's software oracle, and the tests
require the text to be byte-identical to the JAX package's. Forest
hierarchies (K > 1) are a later slice of the port.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import netlist as nl_mod
from repro_torch.core.tree import ParallelTree


def _comparator_expr(x_name: str, bits: int, t_int: int) -> str:
    if t_int >= (1 << bits) - 1:
        return "1'b0"  # X > max is constant false
    return f"({x_name}[7:{8 - bits}] > {bits}'d{t_int})"


def _tree_body_lines(cells: nl_mod.TreeCells) -> list[str]:
    """Comparator + path-AND wires, printed from the netlist cells."""
    lines = []
    for i, comp in enumerate(cells.comparators):
        expr = _comparator_expr(f"x{comp.feature}", comp.bits, comp.t_int)
        lines.append(f"  wire d{i} = {expr};")
    for l, leaf in enumerate(cells.leaves):
        lits = [f"d{c}" if pos else f"~d{c}" for c, pos in leaf.literals]
        expr = " & ".join(lits) if lits else "1'b1"
        lines.append(f"  wire leaf{l} = {expr};")
    return lines


def _class_or_expr(cells: nl_mod.TreeCells, pred) -> str:
    ors = [f"leaf{l}" for l, leaf in enumerate(cells.leaves)
           if pred(leaf.leaf_class)]
    return " | ".join(ors) if ors else "1'b0"


def emit_verilog(
    pt: ParallelTree,
    bits: np.ndarray,
    t_int: np.ndarray,
    module_name: str = "bespoke_dtree",
    trunc=None,
) -> str:
    """Emit a bespoke Verilog module for one (approximate) tree.

    bits/t_int: per-comparator precision and SUBSTITUTED integer threshold;
    trunc (optional) per-comparator LSB-truncation depths. Inputs are the
    8-bit master codes of each used feature; comparators slice their top
    `bits - trunc` bits and compare against `t_int >> trunc`.
    """
    nb = nl_mod.NetlistBuilder()
    cells = nl_mod.build_tree_cells(nb, pt, bits, t_int, pt.n_classes,
                                    trunc=trunc)
    n_cls_bits = nl_mod.class_bits(pt.n_classes)
    used_features = sorted(set(int(f) for f in pt.feature))
    lines = [
        f"// Auto-generated bespoke approximate decision tree",
        f"// comparators={pt.n_comparators} leaves={pt.n_leaves} classes={pt.n_classes}",
        f"module {module_name} (",
    ]
    lines += [f"    input  wire [7:0] x{f}," for f in used_features]
    lines += [f"    output wire [{n_cls_bits - 1}:0] class_out", ");"]
    lines += _tree_body_lines(cells)
    # one-hot class encoder: OR of leaves per class bit
    for b in range(n_cls_bits):
        rhs = _class_or_expr(cells, lambda c: (c >> b) & 1)
        lines.append(f"  assign class_out[{b}] = {rhs};")
    lines.append("endmodule")
    return "\n".join(lines) + "\n"


def emit_circuit_verilog(circuit: nl_mod.Circuit,
                         module_name: str = "bespoke_circuit") -> str:
    """Emit a finished gate-level `netlist.Circuit` as structural Verilog:
    one wire per gate, the 8-bit master-code ports its input gates read,
    the class-index bits LSB first (the printed-MLP circuits of
    `netlist.build_mlp_circuit`)."""
    op, a, b = circuit.op, circuit.a, circuit.b
    features = sorted({int(f) for f in a[op == nl_mod.INPUT]})
    n_out = len(circuit.out_bits)
    lines = [
        "// Auto-generated bespoke gate-level circuit",
        f"// gates={int(op.shape[0])} classes={circuit.n_classes}",
        f"module {module_name} (",
    ]
    lines += [f"    input  wire [7:0] x{f}," for f in features]
    lines += [f"    output wire [{max(n_out - 1, 0)}:0] class_out", ");"]
    exprs = {0: "1'b0", 1: "1'b1"}  # CONST0/CONST1 are always gates 0 and 1
    symbols = {nl_mod.AND: "&", nl_mod.OR: "|", nl_mod.XOR: "^"}
    for g in range(op.shape[0]):
        o = int(op[g])
        if o in (nl_mod.CONST0, nl_mod.CONST1):
            continue
        if o == nl_mod.INPUT:
            rhs = f"x{int(a[g])}[{int(b[g])}]"
        elif o == nl_mod.NOT:
            rhs = f"~{exprs[int(a[g])]}"
        else:
            rhs = f"{exprs[int(a[g])]} {symbols[o]} {exprs[int(b[g])]}"
        lines.append(f"  wire g{g} = {rhs};")
        exprs[g] = f"g{g}"
    for i, w in enumerate(circuit.out_bits):
        lines.append(f"  assign class_out[{i}] = {exprs[int(w)]};")
    lines.append("endmodule")
    return "\n".join(lines) + "\n"


def emit_design(ptrees, bits, t_int, n_classes: int | None = None,
                module_name: str | None = None, trunc=None,
                vote_adder: str = "exact") -> str:
    """One entry point: a single tree emits `emit_verilog` (the vote mode is
    inert for a single tree, which has no vote stage)."""
    if isinstance(ptrees, ParallelTree):
        ptrees = [ptrees]
    if len(ptrees) != 1:
        raise NotImplementedError(
            "forest RTL (K > 1 trees) is not ported yet: ROADMAP.md Queue 1 "
            "item 8")
    if vote_adder not in ("exact", "approx"):
        raise ValueError(f"unknown vote_adder {vote_adder!r}")
    return emit_verilog(ptrees[0], bits, t_int,
                        module_name=module_name or "bespoke_dtree",
                        trunc=trunc)
