"""Family "tree": one CART tree of a dataset, the bespoke approximate tree
that arXiv:2203.08011 searches.

A configuration names the dataset, its split and how the tree is grown
(``max_depth``, and ``max_leaf_nodes`` where the source states the tree's
size). Its inputs are the test split and the tree, made by the
benchmark's own reference (`perfbench.reference.data`, `.cart`). What a
kind asks of a family:

  make_inputs(config)     the inputs, as numpy arrays (cached by
                          `perfbench.inputs`);
  problem(ctx)            the port's search problem of those inputs, and
                          the shapes the metrics count with, among them
                          ``gen_ops`` and ``gen_peak``: the operations one
                          generation needs and the peak they run at;
  objectives(ctx)         the plain reference's objectives of genes;
  exact_circuit(ctx)      the port's gate netlist of the exact design;
  exact_classes(ctx, x8)  the plain reference's classes of the exact
                          design, the circuit's oracle.
"""
from __future__ import annotations

import numpy as np

from perfbench import peaks
from perfbench.reference import cart, data
from perfbench.reference import search as ref

FORM_KEYS = ("feature", "threshold", "path", "path_len", "n_neg",
             "leaf_class")


def make_inputs(config: dict) -> dict:
    if config.get("n_trees", 1) != 1:
        raise ValueError("family tree grows one tree; a forest is a family "
                         "of its own")
    ds = data.load(config["dataset"], config["test_fraction"],
                   config["split_seed"])
    tree = cart.train_tree(ds["x_train"], ds["y_train"], ds["n_classes"],
                           max_depth=config["max_depth"],
                           max_leaf_nodes=config.get("max_leaf_nodes"))
    return {"x_test": ds["x_test"], "y_test": ds["y_test"],
            "n_classes": np.int64(ds["n_classes"]),
            **{f"tree_{k}": v for k, v in tree.items()}}


def tree_of(inputs: dict) -> dict:
    """The node arrays of the inputs' tree."""
    return {k[len("tree_"):]: v for k, v in inputs.items()
            if k.startswith("tree_")}


def _parallel_tree(ctx):
    from repro_torch.core.tree import ParallelTree

    form = cart.comparator_form(tree_of(ctx.inputs))
    return ParallelTree(**{k: form[k] for k in FORM_KEYS},
                        n_classes=int(ctx.inputs["n_classes"])), form


def generation_needs(shape: dict) -> tuple[float, float]:
    """(operations, their peak per second) of one generation's fitness:
    every row walks its root-to-leaf path once per chromosome, P * B *
    (mean path + 1) integer compares at the CUDA cores' rate. The sort,
    crowding and operators are left out, so this bounds every kernel's
    share from above."""
    return (shape["pop"] * shape["rows"] * (shape["mean_depth"] + 1),
            peaks.FP32_OPS_PER_S)


def problem(ctx):
    from repro_torch.search import problem as problem_mod

    pt, form = _parallel_tree(ctx)
    x_test, y_test = ctx.inputs["x_test"], ctx.inputs["y_test"]
    x8 = data.quantize_u8(x_test)
    _, depth = cart.descend(tree_of(ctx.inputs), x8)
    pop = int(ctx.traffic["pop_size"])
    shape = {"family": "tree", "pop": pop, "rows": int(x8.shape[0]),
             "features": int(x8.shape[1]),
             "classes": int(ctx.inputs["n_classes"]),
             "comparators": int(form["feature"].size),
             "features_used": int(np.unique(form["feature"]).size),
             "mean_depth": float(depth.mean())}
    shape["gen_ops"], shape["gen_peak"] = generation_needs(shape)
    return problem_mod.build_tree_problem(pt, x_test, y_test,
                                          device=ctx.device), shape


def objectives(ctx):
    tree = tree_of(ctx.inputs)
    return ref.TreeObjectives(tree, cart.comparator_form(tree),
                              data.quantize_u8(ctx.inputs["x_test"]),
                              ctx.inputs["y_test"], ctx.device)


def exact_circuit(ctx):
    """Every comparator at 8 bits against its trained threshold, lowered by
    the port's `core.netlist.build_circuit`."""
    from repro_torch.core import netlist

    pt, form = _parallel_tree(ctx)
    t_int = np.floor(form["threshold"].astype(np.float64) * 256).astype(
        np.int64)
    return netlist.build_circuit(pt, np.full(t_int.size, 8), t_int,
                                 int(ctx.inputs["n_classes"]))


def exact_classes(ctx, x8) -> np.ndarray:
    return cart.descend(tree_of(ctx.inputs), x8)[0]
