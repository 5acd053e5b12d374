"""The `ClassifierFamily` protocol: one kind of printed classifier the
NSGA-II engine can search.

The counterpart of `repro.families.base`. The engine layers
(`search.engine`, `search.backends`, `search.artifact`,
`runtime.classify` and the CLI) speak only this protocol; everything
tree-specific sits behind `families/tree.py` and everything MLP-specific
behind `families/printed_mlp.py`. A family owns five concerns:

  1. problem construction and genes: `build_problem` binds a dataset to a
     family-specific problem on a device; `n_genes` / `exact_genes` define
     the real-coded [0, 1] chromosome and the exact (lossless) design;
  2. fitness: `make_fitness(problem, backend)` returns the population
     fitness ``(P, n_genes) -> (P, 2)`` for the ``reference`` (plain torch)
     and ``kernel`` (Hopper kernel) backends, which agree exactly;
  3. sweep padding: `problem_dims` / `pad_problem` /
     `population_objectives` lower the problem onto bucket-boundary shapes
     with *inert* padding, so the multi-dataset campaign stacks a bucket's
     problems of one family on a leading axis (`search.sweep` keys its
     buckets by ``(family, dims)``);
  4. hardware lowering: `write_artifact` writes the family-tagged
     `pareto.json` (with Verilog under ``emit_rtl``) and, under
     ``verify_rtl``, requires netlist simulation == tensor predict ==
     kernel for every pareto point;
  5. serving: `load_artifact` rebuilds a design from the JSON alone and
     `make_server` stands up a `runtime.classify.ClassifyServer` for it.

Methods raise `NotImplementedError` here; concrete families override all
of them.
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

    # -- sweep padding -----------------------------------------------------

    def problem_dims(self, problem) -> tuple:
        """Real (unpadded) operand extents: the bucket shape key."""
        raise NotImplementedError

    def pad_problem(self, problem, dims: tuple):
        """Pad to bucket dims with inert padding, on the problem's device;
        `search.sweep.stack_padded` stacks the results of one bucket."""
        raise NotImplementedError

    def population_objectives(self, padded, pop):
        """([K,] P, padded n_genes) -> ([K,] P, 2) on a padded problem (or
        a stacked bucket of them)."""
        raise NotImplementedError

    def padded_n_genes(self, dims: tuple) -> int:
        """Chromosome length at padded bucket dims."""
        raise NotImplementedError

    def padded_exact_genes(self, dims: tuple):
        """Exact-design seed chromosome at padded dims (inert pad genes)."""
        raise NotImplementedError

    def unpad_genes(self, problem, genes, dims: tuple):
        """Map a padded population's gene columns back to `problem`'s real
        layout. Not necessarily a prefix slice: a layout with trailing
        design-level genes must relocate them."""
        raise NotImplementedError

    def eval_cost(self, dims: tuple) -> float:
        """Dominant per-chromosome operation count at padded dims (what
        the bucket planner merges by)."""
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
