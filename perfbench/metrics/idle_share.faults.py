"""Device layer, fault cells: 1 - (the union of the card's activity over
the traced campaign's window)."""
from perfbench import readers


def read(record):
    return readers.idle_share(record, "faults")
