"""Design-space search of trees and forests: `SearchProblem`, the
reference and kernel fitness backends, `run_search` (chunked generations,
checkpoint/resume), the `pareto.json` artifact, the full-suite campaign
(`run_sweep`) and the stuck-at robustness campaign (`robustness`,
`fault_report.json`). CLI: ``python -m repro_torch.search --dataset seeds
--backend kernel``, ``python -m repro_torch.search sweep --datasets all
--report``, ``python -m repro_torch.search serve --pareto
OUT/pareto.json`` and ``python -m repro_torch.search faults --pareto
OUT/pareto.json``.
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
from repro_torch.search.sweep import (
    SweepConfig,
    SweepResult,
    build_problems,
    pad_problem,
    plan_buckets,
    round_up_pow2,
    run_sweep,
    write_sweep_report,
)
from repro_torch.search.artifact import (
    ParetoArtifact,
    load_pareto_artifact,
)
from repro_torch.search.robustness import (
    load_fault_report,
    run_campaign,
    validate_fault_report,
    write_fault_report,
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
    "SweepConfig",
    "SweepResult",
    "build_problems",
    "pad_problem",
    "plan_buckets",
    "round_up_pow2",
    "run_sweep",
    "write_sweep_report",
    "ParetoArtifact",
    "load_pareto_artifact",
    "load_fault_report",
    "run_campaign",
    "validate_fault_report",
    "write_fault_report",
]
