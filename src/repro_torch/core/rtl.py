"""Bespoke RTL (Verilog) emission for trees, forests and finished netlists.

A copy of `repro.core.rtl`: a tree (or each tree of a forest, under a
majority-vote top module) is lowered to the gate-level netlist IR
(`core.netlist`) and the Verilog is printed from its cells; any other
circuit (the printed MLP) is printed gate by gate. Either way
`netlist.simulate` is the emitted module's software oracle, and the tests
require the text to be byte-identical to the JAX package's.
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


def emit_forest_verilog(ptrees, bits, t_int, n_classes: int | None = None,
                        module_name: str = "bespoke_forest", trunc=None,
                        vote_adder: str = "exact") -> str:
    """Emit a bespoke forest: one vote module per tree and the majority-vote
    top module.

    bits/t_int (and trunc) are concatenated per-comparator arrays over the K
    trees. Each tree module emits its one-hot class vote (the OR of its
    class's leaves); the top module counts the votes per class (an adder
    tree for ``vote_adder="exact"``, the 1-bit OR for ``"approx"``) and
    picks the argmax, ties to the lowest class, as `predict_votes` and the
    kernels do.
    """
    if vote_adder not in ("exact", "approx"):
        raise ValueError(f"unknown vote_adder {vote_adder!r}")
    if isinstance(ptrees, ParallelTree):
        ptrees = [ptrees]
    if n_classes is None:
        n_classes = max(pt.n_classes for pt in ptrees)
    bits = np.asarray(bits)
    t_int = np.asarray(t_int)
    trunc = (np.zeros_like(bits) if trunc is None else np.asarray(trunc))
    n_trees = len(ptrees)
    n_cls_bits = nl_mod.class_bits(n_classes)
    approx_vote = vote_adder == "approx"
    # exact counts reach K; the approximate OR saturates at 1 bit
    cnt_bits = 1 if approx_vote else max(1, n_trees.bit_length())

    nb = nl_mod.NetlistBuilder()
    all_cells, off = [], 0
    for pt in ptrees:
        n = pt.n_comparators
        all_cells.append(nl_mod.build_tree_cells(
            nb, pt, bits[off:off + n], t_int[off:off + n], n_classes,
            trunc=trunc[off:off + n]))
        off += n

    lines = [
        f"// Auto-generated bespoke approximate random forest",
        f"// trees={n_trees} comparators={off} classes={n_classes}",
    ]
    for k, (pt, cells) in enumerate(zip(ptrees, all_cells)):
        used = sorted(set(int(f) for f in pt.feature))
        lines.append(f"module {module_name}_tree{k} (")
        lines += [f"    input  wire [7:0] x{f}," for f in used]
        lines += [f"    output wire [{n_classes - 1}:0] vote", ");"]
        lines += _tree_body_lines(cells)
        for c in range(n_classes):
            rhs = _class_or_expr(cells, lambda lc: lc == c)
            lines.append(f"  assign vote[{c}] = {rhs};")
        lines.append("endmodule")
        lines.append("")

    used_all = sorted({int(f) for pt in ptrees for f in pt.feature})
    lines.append(f"module {module_name} (")
    lines += [f"    input  wire [7:0] x{f}," for f in used_all]
    lines += [f"    output wire [{n_cls_bits - 1}:0] class_out", ");"]
    for k, pt in enumerate(ptrees):
        used = sorted(set(int(f) for f in pt.feature))
        ports = ", ".join([f".x{f}(x{f})" for f in used] + [f".vote(vote{k})"])
        lines.append(f"  wire [{n_classes - 1}:0] vote{k};")
        lines.append(f"  {module_name}_tree{k} t{k} ({ports});")
    if approx_vote:
        lines.append("  // approximate vote adder: saturating OR-tree "
                     "(DESIGN.md §16)")
        for c in range(n_classes):
            total = " | ".join(f"vote{k}[{c}]" for k in range(n_trees))
            lines.append(f"  wire [{cnt_bits - 1}:0] cnt{c} = {total};")
    else:
        lines.append("  // majority-vote adder tree "
                     "(the vote matmul in hardware)")
        for c in range(n_classes):
            total = " + ".join(f"vote{k}[{c}]" for k in range(n_trees))
            lines.append(f"  wire [{cnt_bits - 1}:0] cnt{c} = {total};")
    lines.append("  // argmax chain, ties -> lowest class index")
    lines.append(f"  wire [{cnt_bits - 1}:0] best0 = cnt0;")
    lines.append(f"  wire [{n_cls_bits - 1}:0] idx0 = {n_cls_bits}'d0;")
    for c in range(1, n_classes):
        lines.append(f"  wire sel{c} = (cnt{c} > best{c - 1});")
        lines.append(f"  wire [{cnt_bits - 1}:0] best{c} = "
                     f"sel{c} ? cnt{c} : best{c - 1};")
        lines.append(f"  wire [{n_cls_bits - 1}:0] idx{c} = "
                     f"sel{c} ? {n_cls_bits}'d{c} : idx{c - 1};")
    lines.append(f"  assign class_out = idx{n_classes - 1};")
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
    inert for a single tree, which has no vote stage), K > 1 the forest
    hierarchy (`emit_forest_verilog`)."""
    if isinstance(ptrees, ParallelTree):
        ptrees = [ptrees]
    if len(ptrees) == 1:
        return emit_verilog(ptrees[0], bits, t_int,
                            module_name=module_name or "bespoke_dtree",
                            trunc=trunc)
    return emit_forest_verilog(ptrees, bits, t_int, n_classes=n_classes,
                               module_name=module_name or "bespoke_forest",
                               trunc=trunc, vote_adder=vote_adder)
