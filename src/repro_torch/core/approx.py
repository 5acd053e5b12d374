"""Dual approximation fitness of a single tree: chromosome -> (accuracy
loss, area).

The counterpart of `repro.core.approx`: a thin single-tree adapter over
`repro_torch.search`. `ApproxProblem` is the K = 1 `SearchProblem`, and
the fitness factories are the search's reference and kernel backends. New
code uses `repro_torch.search` directly (`build_tree_problem` /
`build_forest_problem` and `run_search`).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.tree import ParallelTree
from repro_torch.search.backends import (make_kernel_fitness,
                                         make_reference_fitness)
from repro_torch.search.problem import (SearchProblem, build_tree_problem,
                                        chromosome_accuracy,
                                        chromosome_area_mm2, objectives)

# the single-tree problem is the K = 1 SearchProblem
ApproxProblem = SearchProblem


def build_problem(ptree: ParallelTree, x_test: np.ndarray, y_test: np.ndarray,
                  device="cuda") -> SearchProblem:
    """Single-tree evaluation context (the K = 1 `SearchProblem`)."""
    return build_tree_problem(ptree, x_test, y_test, device=device)


def make_fitness_fn(problem: SearchProblem):
    """Population fitness (P, 3N+1) -> (P, 2): the reference backend."""
    return make_reference_fitness(problem)


def make_fitness_fn_kernel(problem: SearchProblem,
                           ptree: ParallelTree | None = None,
                           n_features: int | None = None):
    """Population fitness through the fused fitness kernel; ``ptree`` and
    ``n_features`` are kept for the reference's signature (the problem
    carries both)."""
    del ptree, n_features
    return make_kernel_fitness(problem)


__all__ = [
    "ApproxProblem",
    "build_problem",
    "chromosome_accuracy",
    "chromosome_area_mm2",
    "objectives",
    "make_fitness_fn",
    "make_fitness_fn_kernel",
]
