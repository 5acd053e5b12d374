"""The `ClassifierFamily` protocol: one kind of printed classifier the
NSGA-II engine can search.

The counterpart of `repro.families.base`. The engine layers
(`search.engine`, `search.backends`, `search.artifact`,
`runtime.classify` and the CLI) speak only this protocol; everything
tree-specific sits behind `families/tree.py` and everything MLP-specific
behind `families/printed_mlp.py`. A family owns four concerns:

  1. problem construction and genes: `build_problem` binds a dataset to a
     family-specific problem on a device; `n_genes` / `exact_genes` define
     the real-coded [0, 1] chromosome and the exact (lossless) design;
  2. fitness: `make_fitness(problem, backend)` returns the population
     fitness ``(P, n_genes) -> (P, 2)`` for the ``reference`` (plain torch)
     and ``kernel`` (Hopper kernel) backends, which agree exactly;
  3. hardware lowering: `write_artifact` writes the family-tagged
     `pareto.json` (with Verilog under ``emit_rtl``) and, under
     ``verify_rtl``, requires netlist simulation == tensor predict ==
     kernel for every pareto point;
  4. serving: `load_artifact` rebuilds a design from the JSON alone and
     `make_server` stands up a `runtime.classify.ClassifyServer` for it.

The sweep-padding methods of the JAX protocol (`problem_dims`,
`pad_problem`, ...) come with the sweep's slice of the port. Methods raise
`NotImplementedError` here; concrete families override all of them.
"""
from __future__ import annotations


class ClassifierFamily:
    """Abstract base for one searchable printed-classifier family."""

    #: registry key ("tree", "mlp"), also the artifact's `family` tag
    name: str = "?"

    # -- problem construction + genes -------------------------------------

    def owns(self, problem) -> bool:
        """True if `problem` is this family's problem type."""
        raise NotImplementedError

    def build_problem(self, dataset: str, **opts):
        """Train the exact design on `dataset` and bind its test split."""
        raise NotImplementedError

    def n_genes(self, problem) -> int:
        """Chromosome length for `problem`."""
        raise NotImplementedError

    def exact_genes(self, problem):
        """(n_genes,) chromosome decoding to the exact (lossless) design."""
        raise NotImplementedError

    def describe(self, problem) -> str:
        """One-line problem summary for CLI headers."""
        raise NotImplementedError

    # -- fitness -----------------------------------------------------------

    def make_fitness(self, problem, backend: str = "reference"):
        """Population fitness `(P, n_genes) -> (P, 2)` on `backend`."""
        raise NotImplementedError

    # -- artifacts + serving -----------------------------------------------

    def write_artifact(self, problem, result, out_dir: str, *,
                       emit_rtl: bool = False, verify_rtl: bool = False,
                       dataset: str | None = None) -> str:
        """Write the family-tagged pareto.json (+ RTL / verify triangle)."""
        raise NotImplementedError

    def load_artifact(self, payload_or_path):
        """Validate + materialize this family's artifact object."""
        raise NotImplementedError

    def make_server(self, artifact, point="best", max_loss: float = 0.01,
                    **opts):
        """Stand up a `runtime.classify.ClassifyServer` for a pareto point."""
        raise NotImplementedError

    def build_point_circuit(self, artifact, idx: int):
        """Gate-level netlist of pareto point `idx` (the serving oracle)."""
        raise NotImplementedError
