"""CUDA graph capture, shared by the chunked generations
(`core.nsga2.make_chunk`) and the fault simulator's chunks
(`core.faults.FaultSimulator`).

A captured graph reads and writes fixed addresses: whoever replays it
must hold every tensor the captured work touches for as long as it
replays, or a later allocation takes that memory.
"""
from __future__ import annotations

import torch


def capture(warmup, body, device):
    """``(graph, body())``: ``body`` captured as one CUDA graph on
    ``device`` after one call of ``warmup`` on a side stream, as capture
    wants (every kernel built and its libraries' handles made first). The
    warm-up runs under sync debug mode "error", so a host sync in it
    raises here instead of breaking the capture."""
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
    with torch.cuda.graph(graph):
        out = body()
    return graph, out
