"""Fitness backends: (P, n_genes) genes -> (P, 2) objectives.

For a tree or forest `SearchProblem` (genes (P, 3N+1)):

  reference — the plain tensor dataflow (`problem.objectives`);
  kernel    — accuracy through the Hopper fused-fitness kernel, one launch
              per population (`kernels.ops.fitness_errors`), area through
              the same integer-quanta LUT gather and vote-adder term.

The two agree exactly: the kernel's counts equal the plain dataflow's, and
both turn the same integer into an accuracy with `problem.accuracy`.
`make_fitness` takes any family's problem and hands it to that family's
own `make_fitness` (`repro_torch.families`), so `engine.run_search` stays
generic.
"""
from __future__ import annotations

import torch

from repro_torch.search.problem import (SearchProblem, accuracy, area_units,
                                        normalized_area, objectives)

BACKENDS = ("reference", "kernel")


def make_reference_fitness(problem: SearchProblem):
    """Population fitness: (P, n_genes) genes -> (P, 2) objectives."""

    def fitness(pop):
        return objectives(problem, pop)

    return fitness


def make_kernel_fitness(problem: SearchProblem):
    """Kernel-backed fitness: accuracy via ONE fused kernel launch for the
    whole population x test set, area via the LUT gather."""
    from repro_torch.kernels import ops as kops

    fit_operands = kops.prepare_fitness_operands(
        problem.x_sel, problem.y, problem.path, problem.path_len,
        problem.n_neg, problem.leaf_class, problem.n_classes)
    n_samples = problem.y.shape[0]
    exact_accuracy = torch.tensor(problem.exact_accuracy, dtype=torch.float32,
                                  device=problem.device)

    def fitness(pop):
        shift, t_eff, bits, vote_cap = kops.decode_population_full(
            problem.threshold, pop)
        errors = kops.fitness_errors(fit_operands, shift, t_eff, vote_cap)
        acc = accuracy(n_samples - errors, n_samples)
        area = normalized_area(problem, area_units(problem, bits, t_eff,
                                                   vote_cap))
        return torch.stack([exact_accuracy - acc, area], dim=1)

    return fitness


def make_fitness(problem, backend: str = "reference"):
    """Backend name -> population fitness function of any family's problem."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown fitness backend {backend!r}; options: {BACKENDS}")
    from repro_torch.families import family_of
    return family_of(problem).make_fitness(problem, backend)
