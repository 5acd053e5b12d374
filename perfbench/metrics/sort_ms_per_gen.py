"""GA layer (`core/nsga2.py` survivors, `kernels/domination.py`,
`csrc/domination.cu`), tree search: device milliseconds of the
non-dominated sort's kernels a generation in the traced chunks."""
from perfbench import readers


def read(record):
    return readers.sort_ms_per_gen(record)
