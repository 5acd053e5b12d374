"""The whole generation's share of the card's peak, printed-MLP search: as
`gen_mfu`, counted by
`families/mlp.py::generation_needs`."""
from perfbench import readers


def read(record):
    return readers.gen_mfu(record)
