"""GA layer, printed-MLP search: as `sort_ms_per_gen`."""
from perfbench import readers


def read(record):
    return readers.sort_ms_per_gen(record)
