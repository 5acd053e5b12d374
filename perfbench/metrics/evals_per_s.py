"""Evaluations completed per second in the tree search: the population times
the generations of every chunk issued in the window, over the window from
the first timed call to the final synchronise."""
from perfbench import readers


def read(record):
    return readers.evals_per_s(record)
