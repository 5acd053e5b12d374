"""Engine layer, printed-MLP search: as `fitness_evals_share`."""
from perfbench import spans


def read(record):
    return spans.evals_share(record)
