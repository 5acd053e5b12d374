"""The whole generation's share of the card's peak, forest search, in
percent: the operations a generation needs over (the traced window a
generation x their peak), counted by the configuration's family
(`families/bagged_forest.py::generation_needs`)."""
from perfbench import readers


def read(record):
    return readers.gen_mfu(record)
