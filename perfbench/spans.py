"""The program's own spans and counters over a traced stretch, and the
readings of them that the per-layer metrics take.

The port marks its layer boundaries with spans and counts its work in
counters (`repro_torch.runtime.trace`). While a profiler records, it
keeps every span it closes, as (name, start_ns, end_ns) on the host's
clock, and what each counter added (`trace.recorded`). In a run of the
benchmark the profiler records the traced stretch alone, so that is what
these read; a run with no traced stretch, or a program without that
module, gives them nothing and each reading is None.

`reduce` gives for each span name:

  calls    its spans;
  host_ms  their intervals, summed;
  self_ms  the same less what their child spans cover.

The device time of the engine's draws comes from the profiler's kernels
(`tracing.kernel_seconds`): the draws are the only random-number kernels
a search runs, eagerly, outside its CUDA graph.
"""
from __future__ import annotations

from perfbench.tracing import kernel_seconds

# a torch random draw on the card (`rand`, `randint` with a generator)
RNG_KERNELS = ("distribution_elementwise_grid_stride_kernel",)


def recorded() -> dict | None:
    """What the program's spans and counters saw while a profiler
    recorded, or None where the program keeps no such record."""
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    return trace.recorded()


def reduce(marks) -> dict:
    """{span name: {calls, host_ms, self_ms}} of (name, start_ns, end_ns)
    spans, each either inside another or apart from it."""
    out = {}
    order = sorted(range(len(marks)),
                   key=lambda i: (marks[i][1], -marks[i][2]))
    children = [0] * len(marks)
    stack = []
    for i in order:
        _, start, end = marks[i]
        while stack and marks[stack[-1]][2] <= start:
            stack.pop()
        if stack:
            children[stack[-1]] += end - start
        stack.append(i)
    for i, (name, start, end) in enumerate(marks):
        s = out.setdefault(name, {"calls": 0, "host_ms": 0.0,
                                  "self_ms": 0.0})
        s["calls"] += 1
        s["host_ms"] += (end - start) / 1e6
        s["self_ms"] += (end - start - children[i]) / 1e6
    return out


# -- readings for the metric files -------------------------------------------
def _seen(record, kind: str) -> dict | None:
    if record.get("kind") != kind or not record.get("trace"):
        return None
    return recorded()


def span(record, kind: str, name: str) -> dict | None:
    """The traced stretch's figures of span ``name``, or None."""
    seen = _seen(record, kind)
    if not seen:
        return None
    found = reduce(seen["spans"]).get(name)
    return found if found and found["calls"] else None


def counted(record, kind: str, name: str) -> int | None:
    """What counter ``name`` added over the traced stretch, or None."""
    seen = _seen(record, kind)
    return seen["counts"].get(name) if seen else None


def summed_per_call(record, kind: str, names, key: str, per: str):
    """``key`` summed over the spans ``names`` that the stretch holds, over
    the calls of span ``per``; None where it holds none of them."""
    found = [span(record, kind, n) for n in names]
    p = span(record, kind, per)
    if not p or not any(found):
        return None
    return sum(s[key] for s in found if s) / p["calls"]


def ratio(record, kind: str, num: str, den: str):
    """Counter ``num`` over counter ``den`` across the stretch, or None."""
    a, b = counted(record, kind, num), counted(record, kind, den)
    return a / b if a is not None and b else None


def evals_share(record):
    """The rows the program's fitness counted as scored
    (``nsga2.evaluations``) over the traced generations times the
    population, or None."""
    rows = counted(record, "search", "nsga2.evaluations")
    if rows is None:
        return None
    return rows / (record["traced_generations"] * record["shape"]["pop"])


def draw_device_ms(record):
    """Device ms of a chunk call's draws: the mean device time of a random
    draw's kernel in the window, times the draws a call made (the counter
    ``nsga2.draws`` over the calls of span ``nsga2.chunk.draw``); None
    without either."""
    calls = span(record, "search", "nsga2.chunk.draw")
    draws = counted(record, "search", "nsga2.draws")
    if not calls or not draws:
        return None
    seconds, kernels = kernel_seconds(record["trace"], RNG_KERNELS)
    if not kernels:
        return None
    return seconds * 1e3 / kernels * draws / calls["calls"]
