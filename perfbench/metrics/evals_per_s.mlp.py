"""Evaluations completed per second in the printed-MLP search, counted as
`evals_per_s` counts them. Its own metric: the MLP's runs spread wider
(the depth of its sort follows the search), so it has a bound of its own."""
from perfbench import readers


def read(record):
    return readers.evals_per_s(record)
