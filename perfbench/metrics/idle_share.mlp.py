"""Device layer, printed-MLP search: as `idle_share.search`."""
from perfbench import readers


def read(record):
    return readers.idle_share(record, "search")
