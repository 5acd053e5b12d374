"""CUDA graph capture of the chunked generations (`core.nsga2.make_chunk`).

A captured graph reads and writes fixed addresses: whoever replays it
must hold every tensor the captured work touches for as long as it
replays, or a later allocation takes that memory.

Counting under a graph: the work a capture records runs only when the
graph is replayed, so whatever the captured body counts in the counters
of `runtime.trace` (the kernels' launch counters among them) is taken
back when the capture ends and added again at every `Graph.replay`.
"""
from __future__ import annotations

import torch

from repro_torch.runtime import trace


class Graph:
    """A captured CUDA graph and what its capture counted: each `replay`
    runs the graph and adds those counts."""

    def __init__(self, graph, counts: dict[str, int]):
        self.graph, self.counts = graph, counts

    def replay(self) -> None:
        self.graph.replay()
        for name, n in self.counts.items():
            trace.count(name, n)


def record(graph, body):
    """``(Graph, body())``: ``body`` (the capture of ``graph``) run once,
    every counter set back to where it stood before it; the `Graph` adds
    what it counted at each replay. Counts one capture."""
    counts = trace.counters()
    out = body()
    added = {name: n - counts.get(name, 0)
             for name, n in trace.counters().items()
             if n != counts.get(name, 0)}
    for name, n in added.items():
        trace.count(name, -n)
    trace.count("graphs.captures")
    return Graph(graph, added), out


def capture(warmup, body, device):
    """``(Graph, body())``: ``body`` captured as one CUDA graph on
    ``device`` after one call of ``warmup`` on a side stream, as capture
    wants (every kernel built and its libraries' handles made first). The
    warm-up runs under sync debug mode "error", so a host sync in it
    raises here instead of breaking the capture; it runs eagerly, so what
    it counts stays counted."""
    with trace.span("graphs.capture"):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                warmup()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()

        def captured():
            with torch.cuda.graph(graph):
                return body()

        return record(graph, captured)
