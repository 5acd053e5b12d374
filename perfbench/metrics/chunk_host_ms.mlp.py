"""Engine layer, printed-MLP search: as `chunk_host_ms`."""
from perfbench import readers


def read(record):
    return readers.chunk_host_ms(record)
