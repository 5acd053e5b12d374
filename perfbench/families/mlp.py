"""Family "mlp": the printed MLP of arXiv:2312.17612, one hidden ReLU layer
of 4-bit master weights on the 8-bit input codes.

A configuration names the dataset, its split, the hidden width and how
the masters are trained (``train``: steps, rate, seed). Its inputs are the
test split and the master codes, made by the benchmark's own reference
(`perfbench.reference.data`, `.mlp`). It offers what `families/tree.py`
lists, but a circuit: no fault cell runs this family yet.
"""
from __future__ import annotations

import numpy as np

from perfbench import peaks
from perfbench.reference import data, mlp
from perfbench.reference import search as ref


def make_inputs(config: dict) -> dict:
    ds = data.load(config["dataset"], config["test_fraction"],
                   config["split_seed"])
    train = config["train"]
    w1, w2 = mlp.train_masters(ds["x_train"], ds["y_train"], ds["n_classes"],
                               config["n_hidden"], train["steps"],
                               train["lr"], train["seed"])
    return {"x_test": ds["x_test"], "y_test": ds["y_test"],
            "n_classes": np.int64(ds["n_classes"]),
            "w1_master": w1, "w2_master": w2}


def generation_needs(shape: dict) -> tuple[float, float]:
    """(operations, their peak per second) of one generation's fitness: the
    two layers of every chromosome, 2 * P * B * (F * H + H * C) int8
    operations at the tensor cores' rate."""
    f, h, c = shape["features"], shape["hidden"], shape["classes"]
    return (2 * shape["pop"] * shape["rows"] * (f * h + h * c),
            peaks.INT8_OPS_PER_S)


def problem(ctx):
    from repro_torch.families import printed_mlp

    w1, w2 = ctx.inputs["w1_master"], ctx.inputs["w2_master"]
    x8 = data.quantize_u8(ctx.inputs["x_test"])
    n_classes = int(ctx.inputs["n_classes"])
    shape = {"family": "mlp", "pop": int(ctx.traffic["pop_size"]),
             "rows": int(x8.shape[0]), "features": int(x8.shape[1]),
             "classes": n_classes, "hidden": int(w1.shape[1])}
    shape["gen_ops"], shape["gen_peak"] = generation_needs(shape)
    return printed_mlp.problem_from_masters(
        w1, w2, printed_mlp.pick_shift(*w1.shape), n_classes, x8,
        ctx.inputs["y_test"], device=ctx.device), shape


def objectives(ctx):
    return ref.MLPObjectives(ctx.inputs["w1_master"], ctx.inputs["w2_master"],
                             data.quantize_u8(ctx.inputs["x_test"]),
                             ctx.inputs["y_test"], ctx.device)
