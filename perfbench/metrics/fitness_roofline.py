"""Kernels layer (`kernels/fitness.py`, `csrc/fitness.cu`): the tree
fitness kernel's share of its roofline, in percent.

What the inputs need, whatever computes it: every row of the test split
walks its root-to-leaf path once per chromosome, D + 1 integer compares
for a path of D comparators, so P * B * (mean D + 1) compares at the
CUDA cores' rate; and the bytes read once and written once: the 8-bit
codes of the distinct features the tree reads, the population's float32
genes, and one int32 count per chromosome. The bound is the larger of the
two times; the share is the bound over the kernel's mean device time per
call in the traced chunks."""
from perfbench import peaks
from perfbench.tracing import kernel_seconds

KERNEL = ("fitness_mma_kernel",)


def needed(pop: int, rows: int, comparators: int, features_used: int,
           mean_depth: float) -> tuple[float, float]:
    """(operations, bytes) of one population's fitness."""
    ops = pop * rows * (mean_depth + 1)
    n_bytes = rows * features_used + pop * (3 * comparators + 1) * 4 + pop * 4
    return ops, n_bytes


def read(record):
    trace = record.get("trace")
    shape = record.get("shape") or {}
    if not trace or "mean_depth" not in shape:
        return None
    seconds, calls = kernel_seconds(trace, KERNEL)
    if not calls:
        return None
    ops, n_bytes = needed(shape["pop"], shape["rows"], shape["comparators"],
                          shape["features_used"], shape["mean_depth"])
    return 100 * peaks.roofline_s(ops, peaks.FP32_OPS_PER_S, n_bytes) / (
        seconds / calls)
