"""Faults layer (`core/faults.py::_ChunkGraph`, `runtime/graphs.py`): CUDA
graphs captured (the counter `graphs.captures`) per traced campaign
(`faults.campaign` calls)."""
from perfbench import spans


def read(record):
    captures = spans.counted(record, "faults", "graphs.captures")
    campaign = spans.span(record, "faults", "faults.campaign")
    if captures is None or campaign is None:
        return None
    return captures / campaign["calls"]
