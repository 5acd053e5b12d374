"""Device layer, forest search: 1 - (the union of the card's activity over
the traced window)."""
from perfbench import readers


def read(record):
    return readers.idle_share(record, "search")
