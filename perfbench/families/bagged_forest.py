"""Family "bagged_forest": a bagged forest of bespoke approximate trees
(arXiv:2203.08011) voting through the forest's vote adder, the joint
search of the port's ``--family tree --trees K``.

A configuration names the dataset and its split, and how the forest is
grown: ``n_trees``, ``bag_seed``, ``feature_fraction`` and ``max_depth``
(each tree grown until its leaves are pure). Its inputs are the test split
and the trees, made by the benchmark's own reference
(`perfbench.reference.data`, `.forest`). It offers what `families/tree.py`
lists, but a circuit: no fault cell runs this family.
"""
from __future__ import annotations

import numpy as np

from perfbench import peaks
from perfbench.reference import cart, data
from perfbench.reference import forest as ref

FORM_KEYS = ("feature", "threshold", "path", "path_len", "n_neg",
             "leaf_class")


def make_inputs(config: dict) -> dict:
    ds = data.load(config["dataset"], config["test_fraction"],
                   config["split_seed"])
    trees = ref.train_forest(ds["x_train"], ds["y_train"], ds["n_classes"],
                             config["n_trees"], config["bag_seed"],
                             config["feature_fraction"], config["max_depth"])
    out = {"x_test": ds["x_test"], "y_test": ds["y_test"],
           "n_classes": np.int64(ds["n_classes"])}
    for k, tree in enumerate(trees):
        out.update({f"tree{k}_{key}": v for key, v in tree.items()})
    return out


def trees_of(ctx) -> list[dict]:
    """The node arrays of the inputs' trees, in the order they were drawn."""
    return [{key[len(f"tree{k}_"):]: v for key, v in ctx.inputs.items()
             if key.startswith(f"tree{k}_")}
            for k in range(int(ctx.config["n_trees"]))]


def generation_needs(shape: dict) -> tuple[float, float]:
    """(operations, their peak per second) of one generation's fitness:
    every row walks each tree's root-to-leaf path once per chromosome, P * B
    * sum_k (mean path_k + 1) integer compares at the CUDA cores' rate. The
    vote, the sort, crowding and operators are left out, so this bounds
    every kernel's share from above."""
    return (shape["pop"] * shape["rows"] * shape["path_compares"],
            peaks.FP32_OPS_PER_S)


def problem(ctx):
    from repro_torch.core.tree import ParallelTree
    from repro_torch.search import problem as problem_mod

    trees = trees_of(ctx)
    forms = [cart.comparator_form(tree) for tree in trees]
    n_classes = int(ctx.inputs["n_classes"])
    x8 = data.quantize_u8(ctx.inputs["x_test"])
    shape = {"family": "bagged_forest", "pop": int(ctx.traffic["pop_size"]),
             "rows": int(x8.shape[0]), "features": int(x8.shape[1]),
             "classes": n_classes, "trees": len(trees),
             "comparators": sum(f["feature"].size for f in forms),
             "leaves": sum(f["leaf_class"].size for f in forms),
             "features_used": int(np.unique(np.concatenate(
                 [f["feature"] for f in forms])).size),
             "path_compares": float(sum(cart.descend(tree, x8)[1].mean() + 1
                                        for tree in trees))}
    shape["gen_ops"], shape["gen_peak"] = generation_needs(shape)
    ptrees = [ParallelTree(**{k: f[k] for k in FORM_KEYS},
                           n_classes=n_classes) for f in forms]
    return problem_mod.build_problem(
        ptrees, ctx.inputs["x_test"], ctx.inputs["y_test"],
        n_classes=n_classes, device=ctx.device), shape


def objectives(ctx):
    return ref.ForestObjectives(trees_of(ctx),
                                data.quantize_u8(ctx.inputs["x_test"]),
                                ctx.inputs["y_test"],
                                int(ctx.inputs["n_classes"]), ctx.device)
