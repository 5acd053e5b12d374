"""What the search cells' metrics read. Each metric file of a search cell
is one of these readings; the cells it reads in are its ``workloads`` in
`BENCHMARK.json`, so a family whose runs spread apart from another's gets
metrics (and a bound) of its own by a file and an entry."""
from __future__ import annotations

from perfbench.tracing import kernel_seconds

SORT_KERNELS = ("domination_bits_kernel", "peel_kernel", "domination_kernel")


def evals_per_s(record):
    """Evaluations completed per second over the window."""
    if record["kind"] != "search":
        return None
    return record["evals"] / record["window_s"]


def chunk_host_ms(record):
    """Host ms of a chunk call in the window (median over the calls)."""
    if record["kind"] != "search":
        return None
    return record["chunk_host_ms"]


def sort_ms_per_gen(record):
    """Device ms of the non-dominated sort's kernels a generation."""
    trace = record.get("trace")
    if record["kind"] != "search" or not trace:
        return None
    seconds, calls = kernel_seconds(trace, SORT_KERNELS)
    if not calls:
        return None
    return seconds * 1e3 / record["traced_generations"]


def idle_share(record, kind: str):
    """1 - the card's busy time over the traced window."""
    trace = record.get("trace")
    if record["kind"] != kind or not trace:
        return None
    return 1 - trace["busy_s"] / trace["window_s"]


def gen_mfu(record):
    """A generation's needed operations (``gen_ops``, counted by the
    configuration's family at ``gen_peak``) over (the traced window a
    generation x that peak), in percent."""
    trace = record.get("trace")
    if record["kind"] != "search" or not trace:
        return None
    shape = record["shape"]
    per_gen = trace["window_s"] / record["traced_generations"]
    return 100 * shape["gen_ops"] / (per_gen * shape["gen_peak"])
