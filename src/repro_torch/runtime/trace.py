"""Spans and counters of the port, at the engine's and the fault campaign's
layer boundaries.

A span (``with span(name):``) is a `torch.profiler.record_function`
range, entered only while a profiler is recording: its start, end and
nesting then sit in the profiler's own event list, on the clock of the
card's kernels and copies, and go out with its trace
(``export_chrome_trace``). With no profiler a span is one check of the
profiler's state and enters nothing (`record_function` costs ~12 us a
use even when nothing records it). No span sits inside a captured CUDA
graph.

A counter (``count(name, n)``) adds to an in-memory registry that
`counters` copies. The kernels' launch counters live in it too, as
``launches.<wrapper>`` (`kernels.launch_counts`). A count made while a
CUDA graph is captured is taken back after the capture and added again at
each replay of the graph (`runtime.graphs.record`, `Graph.replay`), so a
counter counts the work the card runs.

While a profiler records, the port also keeps what it saw, for a reader
that has no hold on the profiler's events: `recorded` gives every span
closed so far (its name, and its start and end on the host's
``perf_counter_ns`` clock; the last 65,536) and what each counter added.
`forget` clears it.

Spans: ``nsga2.chunk`` (a `make_chunk` call) and, on the card, its
``nsga2.chunk.draw``, ``.load``, ``.replay`` and ``.unload``;
``graphs.capture``; ``faults.campaign`` (`point_robustness`) and its
``faults.simulator``, ``faults.oracle``, ``faults.draws``,
``faults.masks``, ``faults.upload``, ``faults.capture`` (the CPU's chunk
step alone), ``faults.lanes``, ``faults.readback`` and ``faults.reduce``.
Counters:
``nsga2.evaluations`` (rows a family's fitness scored), ``nsga2.draws``
(random tensors the engine drew), ``graphs.captures``, ``faults.lanes``,
``faults.upload_bytes`` (host arrays handed to the simulator's device),
``faults.readback_bytes`` (predictions brought back),
``fitness.path_macs`` (the int8 multiply-adds the tree fitness kernel's
path product runs, `kernels.fitness.FitnessOperands.path_macs`; the
CPU's plain version counts none) and the launch counters (the fault
simulator's ``launches.fault_lanes`` among them).
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch

_OFF = contextlib.nullcontext()
_COUNTS: dict[str, int] = {}
_SPANS: collections.deque = collections.deque(maxlen=1 << 16)
_RECORDED_COUNTS: dict[str, int] = {}
_recording = torch._C._autograd._profiler_enabled


class _Span:
    """A `record_function` range that also keeps its host interval."""

    def __init__(self, name: str):
        self.name = name
        self.inner = torch.profiler.record_function(name)

    def __enter__(self):
        self.inner.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        _SPANS.append((self.name, self.start, time.perf_counter_ns()))
        return self.inner.__exit__(*exc)


def span(name: str):
    """A context manager timing its block as ``name`` under a recording
    profiler, and doing nothing otherwise."""
    return _Span(name) if _recording() else _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + int(n)
    if _recording():
        _RECORDED_COUNTS[name] = _RECORDED_COUNTS.get(name, 0) + int(n)


def counters() -> dict[str, int]:
    """A copy of every counter."""
    return dict(_COUNTS)


def recorded() -> dict:
    """What the spans and counters saw while a profiler recorded:
    ``{"spans": [(name, start_ns, end_ns), ...] in order of their end,
    "counts": {name: n added}}``."""
    return {"spans": list(_SPANS), "counts": dict(_RECORDED_COUNTS)}


def forget() -> None:
    """Clear what `recorded` gives."""
    _SPANS.clear()
    _RECORDED_COUNTS.clear()
