"""The whole generation's share of the card's peak, tree search, in percent:
the operations a generation needs over (the traced window a generation x
their peak), counted by the configuration's family
(`families/tree.py::generation_needs`)."""
from perfbench import readers


def read(record):
    return readers.gen_mfu(record)
