"""The decision-tree and forest family: `search.SearchProblem` behind the
protocol.

The counterpart of `repro.families.tree`. Every method delegates to the
port's tree modules (`search.problem`, `search.backends`, `search.engine`,
`search.artifact`, `runtime.classify`, `core.netlist`) and changes none of
their behaviour; ``n_trees > 1`` trains a bootstrap forest
(`core.forest.train_forest`).
"""
from __future__ import annotations

from repro_torch.families.base import ClassifierFamily
from repro_torch.search.problem import SearchProblem


class TreeFamily(ClassifierFamily):
    """Bespoke decision trees and bootstrap forests (paper arxiv
    2203.08011)."""

    name = "tree"

    def owns(self, problem) -> bool:
        return isinstance(problem, SearchProblem)

    def build_problem(self, dataset: str, n_trees: int = 1, device="cuda"):
        from repro_torch.core.forest import train_forest
        from repro_torch.core.train import train_tree
        from repro_torch.core.tree import to_parallel
        from repro_torch.datasets import load_dataset
        from repro_torch.search.problem import (build_forest_problem,
                                                build_tree_problem)

        ds = load_dataset(dataset)
        if n_trees <= 1:
            tree = train_tree(ds.x_train, ds.y_train, ds.n_classes)
            return build_tree_problem(to_parallel(tree), ds.x_test, ds.y_test,
                                      device=device)
        forest = train_forest(ds.x_train, ds.y_train, ds.n_classes,
                              n_trees=n_trees)
        return build_forest_problem(forest, ds.x_test, ds.y_test,
                                    device=device)

    def n_genes(self, problem) -> int:
        return problem.n_genes

    def exact_genes(self, problem):
        return problem.exact_genes()

    def describe(self, problem) -> str:
        kind = ("tree" if problem.n_trees == 1
                else f"forest[{problem.n_trees}]")
        return (f"{kind}: comparators={problem.n_comparators} "
                f"leaves={problem.n_leaves} "
                f"exact_acc={problem.exact_accuracy:.3f}")

    def make_fitness(self, problem, backend: str = "reference"):
        from repro_torch.search import backends

        if backend == "reference":
            return backends.make_reference_fitness(problem)
        if backend == "kernel":
            return backends.make_kernel_fitness(problem)
        raise ValueError(f"unknown fitness backend {backend!r} for the "
                         f"tree family")

    def write_artifact(self, problem, result, out_dir: str, *,
                       emit_rtl: bool = False, verify_rtl: bool = False,
                       dataset: str | None = None) -> str:
        from repro_torch.search import engine
        return engine.write_pareto_artifact(
            problem, result, out_dir, emit_rtl=emit_rtl,
            verify_rtl=verify_rtl, dataset=dataset)

    def load_artifact(self, payload_or_path):
        from repro_torch.search import artifact

        if isinstance(payload_or_path, str):
            return artifact.load_pareto_artifact(payload_or_path)
        return artifact.from_payload(payload_or_path)

    def make_server(self, artifact, point="best", max_loss: float = 0.01,
                    **opts):
        from repro_torch.runtime.classify import ClassifyServer
        return ClassifyServer.from_artifact(artifact, point=point,
                                            max_loss=max_loss, **opts)

    def build_point_circuit(self, artifact, idx: int):
        from repro_torch.core import netlist
        bits, t_int, trunc, vote_adder = artifact.point_design(idx)
        return netlist.build_circuit(artifact.ptrees(), bits, t_int,
                                     artifact.n_classes, trunc=trunc,
                                     vote_adder=vote_adder)


FAMILY = TreeFamily()
