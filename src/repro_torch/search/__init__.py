"""Design-space search of trees and forests: `SearchProblem`, the
reference and kernel fitness backends, `run_search` (chunked generations,
checkpoint/resume) and the `pareto.json` artifact. CLI: ``python -m repro_torch.search --dataset seeds --backend
kernel`` and ``python -m repro_torch.search serve --pareto OUT/pareto.json``.
"""
from repro_torch.search.problem import (
    SearchProblem,
    build_forest_problem,
    build_problem,
    build_tree_problem,
    chromosome_accuracy,
    chromosome_area_mm2,
    decode_chromosome,
    objectives,
    predict_votes,
    problem_ptrees,
)
from repro_torch.search.backends import (
    BACKENDS,
    make_fitness,
    make_kernel_fitness,
    make_reference_fitness,
)
from repro_torch.search.engine import (
    SearchConfig,
    SearchResult,
    netlist_area_ratios,
    run_search,
    write_pareto_artifact,
)
from repro_torch.search.artifact import (
    ParetoArtifact,
    load_pareto_artifact,
)

__all__ = [
    "SearchProblem",
    "build_forest_problem",
    "build_problem",
    "build_tree_problem",
    "chromosome_accuracy",
    "chromosome_area_mm2",
    "decode_chromosome",
    "objectives",
    "predict_votes",
    "problem_ptrees",
    "BACKENDS",
    "make_fitness",
    "make_kernel_fitness",
    "make_reference_fitness",
    "SearchConfig",
    "SearchResult",
    "netlist_area_ratios",
    "run_search",
    "write_pareto_artifact",
    "ParetoArtifact",
    "load_pareto_artifact",
]
