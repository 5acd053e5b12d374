"""Kernels layer (`kernels/qmatmul.py`, `csrc/qmatmul.cu`): the printed
MLP's first-layer `qmatmul` share of its roofline, in percent.

The whole population's first layer is one (B x F) uint8 by (F x P*H) int8
product with a float32 (B x P*H) result: 2 * B * F * P * H operations at
the int8 tensor-core peak, and B * F + F * P * H + 4 * B * P * H bytes.
The share is the bound over the kernel's mean device time per call."""
from perfbench import peaks
from perfbench.tracing import kernel_seconds

KERNEL = ("qmatmul",)


def needed(rows: int, features: int, columns: int) -> tuple[float, float]:
    """(operations, bytes) of one (rows x features) @ (features x columns)
    product."""
    return (2 * rows * features * columns,
            rows * features + features * columns + 4 * rows * columns)


def read(record):
    trace = record.get("trace")
    shape = record.get("shape") or {}
    if not trace or "hidden" not in shape:
        return None
    seconds, calls = kernel_seconds(trace, KERNEL)
    if not calls:
        return None
    ops, n_bytes = needed(shape["rows"], shape["features"],
                          shape["pop"] * shape["hidden"])
    return 100 * peaks.roofline_s(ops, peaks.INT8_OPS_PER_S, n_bytes) / (
        seconds / calls)
