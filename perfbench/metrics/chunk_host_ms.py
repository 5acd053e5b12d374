"""Engine layer (`search/engine.py`'s loop, `core/nsga2.py::make_chunk`,
`_GraphChunk.run`), tree search: host milliseconds of a chunk call in the
window (its eager draws, the state copies and the graph's replay
enqueued), the median of the host clock around every call. Once the
card's queue is full a call waits for room in it, so where the card paces
the loop this reads the card's time a chunk."""
from perfbench import readers


def read(record):
    return readers.chunk_host_ms(record)
