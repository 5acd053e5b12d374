"""Kernels layer (`kernels/fitness.py`, `csrc/fitness.cu`), forest search:
the tree fitness kernel's share of its roofline over a forest's
block-diagonal super-tree, in percent.

Counted as `fitness_roofline` counts it, summed over the trees: every row
of the test split walks each tree's root-to-leaf path once per
chromosome, P * B * sum_k (mean D_k + 1) compares (the family's
``path_compares``) at the CUDA cores' rate, against the bytes of the
codes of the distinct features the trees read, the population's genes
and its counts; the share is the bound over the kernel's mean device time
per call in the traced chunks."""
from pathlib import Path

from perfbench import harness

TREE = harness.load_module(Path(__file__).with_name("fitness_roofline.py"))


def read(record):
    shape = record.get("shape") or {}
    if "path_compares" not in shape:
        return None
    as_one_path = dict(shape, mean_depth=shape["path_compares"] - 1)
    return TREE.read(dict(record, shape=as_one_path))
