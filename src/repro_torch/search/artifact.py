"""`pareto.json` schema: one validated contract for writer and loader.

A copy of `repro.search.artifact` (tree family): the port writes and reads
the same file, so a design searched by either package serves from either.
A payload tagged with another family (``"family": "mlp"``) is handed to
that family's loader (`repro_torch.families`).

`engine.write_pareto_artifact` (the writer) and `load_pareto_artifact`
(the serving loader, DESIGN.md §14) share the key sets below, so the two
sides cannot drift apart silently: the writer validates its payload through
`validate_payload` before dumping, and the loader validates on the way in —
a missing or unknown key raises a `ValueError` naming the offending keys
instead of surfacing as a `KeyError` deep inside the serving runtime.

The artifact is fully self-contained: besides the trained float `threshold`
and comparator `feature` map it records the block-diagonal super-tree
layout (`path`, `path_len`, `n_neg`, `leaf_class`, per-tree
`tree_comparators`/`tree_leaves`), so `ParetoArtifact.ptrees()` rebuilds
the per-tree `ParallelTree`s — and from there the gate-level netlist, RTL,
or a `ClassifyServer` — from the JSON alone, no dataset or training run
required. Each pareto point stores the *decoded* design — pre-truncation
`bits` + substituted integer thresholds `t_int`, plus the cross-layer
approximation config of DESIGN.md §16: per-comparator `trunc` LSB-drop
counts and the forest-level `vote_adder` mode — sidestepping the rounded
`genes` entirely: re-serving a point reproduces its recorded accuracy
bit-exactly. `trunc`/`vote_adder` values are validated on write AND load
(range [0, MAX_TRUNC], mode in VOTE_ADDER_MODES) with named `ValueError`s,
same as the key sets.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.core.tree import ParallelTree

# The writer/loader contract. OPTIONAL keys may be absent; anything outside
# REQUIRED | OPTIONAL is an error in both directions (the artifact may only
# grow by extending these sets, keeping old loaders loud about new files and
# new loaders loud about hand-mangled ones).
REQUIRED_TOP_KEYS = frozenset({
    "backend", "wall_s", "n_evaluations", "n_dispatches",
    "n_trees", "n_comparators", "n_classes",
    "tree_comparators", "tree_leaves",
    "feature", "threshold", "path", "path_len", "n_neg", "leaf_class",
    "exact_accuracy", "exact_area_mm2", "rtl_verified", "pareto",
})
OPTIONAL_TOP_KEYS = frozenset({"dataset", "family"})
REQUIRED_POINT_KEYS = frozenset({
    "acc_loss", "norm_area", "area_mm2", "area_netlist_mm2",
    "netlist_gates", "bits", "margin", "t_int", "trunc", "vote_adder",
    "genes",
})
OPTIONAL_POINT_KEYS = frozenset({"rtl", "verified"})


def _check_keys(have, required, optional, where: str) -> None:
    have = set(have)
    missing = sorted(required - have)
    unknown = sorted(have - required - optional)
    problems = []
    if missing:
        problems.append(f"missing keys {missing}")
    if unknown:
        problems.append(f"unknown keys {unknown}")
    if problems:
        raise ValueError(
            f"pareto artifact {where}: {'; '.join(problems)} "
            f"(expected {sorted(required)} + optional {sorted(optional)})")


def validate_payload(payload: dict, where: str = "payload") -> dict:
    """Validate a pareto.json payload against the shared schema.

    Checks the top-level and per-point key sets both ways (missing AND
    unknown keys raise `ValueError`), plus the cross-field layout
    invariants the loader's array reconstruction depends on. Returns the
    payload unchanged so callers can chain it.
    """
    if not isinstance(payload, dict):
        raise ValueError(f"pareto artifact {where}: expected a JSON object, "
                         f"got {type(payload).__name__}")
    _check_keys(payload, REQUIRED_TOP_KEYS, OPTIONAL_TOP_KEYS, where)
    family = payload.get("family", "tree")
    if family != "tree":
        raise ValueError(
            f"pareto artifact {where}: family {family!r} does not match the "
            f"tree schema")
    points = payload["pareto"]
    if not isinstance(points, list):
        raise ValueError(f"pareto artifact {where}: 'pareto' must be a list")
    for i, point in enumerate(points):
        if not isinstance(point, dict):
            raise ValueError(
                f"pareto artifact {where}: pareto[{i}] must be an object")
        _check_keys(point, REQUIRED_POINT_KEYS, OPTIONAL_POINT_KEYS,
                    f"{where}.pareto[{i}]")

    n = payload["n_comparators"]
    l = len(payload["path_len"])
    if sum(payload["tree_comparators"]) != n:
        raise ValueError(
            f"pareto artifact {where}: tree_comparators "
            f"{payload['tree_comparators']} do not sum to n_comparators={n}")
    if sum(payload["tree_leaves"]) != l:
        raise ValueError(
            f"pareto artifact {where}: tree_leaves {payload['tree_leaves']} "
            f"do not sum to the {l} leaves of path_len")
    if len(payload["tree_comparators"]) != payload["n_trees"]:
        raise ValueError(
            f"pareto artifact {where}: {len(payload['tree_comparators'])} "
            f"tree_comparators entries for n_trees={payload['n_trees']}")
    for key in ("feature", "threshold"):
        if len(payload[key]) != n:
            raise ValueError(
                f"pareto artifact {where}: {key!r} has {len(payload[key])} "
                f"entries, expected n_comparators={n}")
    if len(payload["path"]) != l or any(len(r) != n for r in payload["path"]):
        raise ValueError(
            f"pareto artifact {where}: 'path' must be {l} rows x {n} "
            f"columns (leaves x comparators)")
    for key in ("n_neg", "leaf_class"):
        if len(payload[key]) != l:
            raise ValueError(
                f"pareto artifact {where}: {key!r} has {len(payload[key])} "
                f"entries, expected {l} leaves")
    from repro_torch.core import quant

    for i, point in enumerate(points):
        for key in ("bits", "margin", "t_int", "trunc"):
            if len(point[key]) != n:
                raise ValueError(
                    f"pareto artifact {where}: pareto[{i}].{key} has "
                    f"{len(point[key])} entries, expected n_comparators={n}")
        bad_trunc = [t for t in point["trunc"]
                     if not (isinstance(t, int)
                             and 0 <= t <= quant.MAX_TRUNC)]
        if bad_trunc:
            raise ValueError(
                f"pareto artifact {where}: pareto[{i}].trunc entries "
                f"{bad_trunc} out of range [0, {quant.MAX_TRUNC}]")
        if point["vote_adder"] not in quant.VOTE_ADDER_MODES:
            raise ValueError(
                f"pareto artifact {where}: pareto[{i}].vote_adder "
                f"{point['vote_adder']!r} not in {quant.VOTE_ADDER_MODES}")
    return payload


@dataclasses.dataclass
class ParetoArtifact:
    """A loaded, validated `pareto.json`: design layout + pareto points.

    Arrays are reconstructed as numpy with the `SearchProblem` dtypes, so
    the artifact plugs straight into `kernels.ops.prepare_operands`,
    `core.netlist.build_circuit` (via `ptrees()`) and
    `runtime.classify.ClassifyServer`.
    """

    payload: dict
    feature: np.ndarray      # (N,) int32
    threshold: np.ndarray    # (N,) float32
    path: np.ndarray         # (L, N) int8 block-diagonal super-tree
    path_len: np.ndarray     # (L,) int32
    n_neg: np.ndarray        # (L,) int32
    leaf_class: np.ndarray   # (L,) int32
    n_trees: int
    n_classes: int
    tree_comparators: tuple
    tree_leaves: tuple
    exact_accuracy: float
    exact_area_mm2: float
    dataset: str | None
    points: list
    family: str = "tree"

    @property
    def n_comparators(self) -> int:
        return int(self.feature.shape[0])

    @property
    def n_leaves(self) -> int:
        return int(self.leaf_class.shape[0])

    def point_design(self, i: int):
        """Pareto point `i`'s decoded design (DESIGN.md §14, §16):
        (bits, t_int, trunc, vote_adder) — `bits`/`t_int`/`trunc` are (N,)
        int arrays with pre-truncation precision/thresholds, `vote_adder`
        is "exact" or "approx". Consumers fold `trunc` into effective
        operands (`kernels.ops.prepare_design`, `netlist.build_circuit`)."""
        point = self.points[i]
        return (np.asarray(point["bits"], np.int32),
                np.asarray(point["t_int"], np.int32),
                np.asarray(point["trunc"], np.int32),
                str(point["vote_adder"]))

    def point_accuracy(self, i: int) -> float:
        """The accuracy this point scored on the search's test split."""
        return self.exact_accuracy - float(self.points[i]["acc_loss"])

    def best_under_loss(self, max_loss: float = 0.01) -> int | None:
        """Index of the smallest-area point within the loss budget."""
        ok = [i for i, p in enumerate(self.points)
              if p["acc_loss"] <= max_loss + 1e-9]
        if not ok:
            return None
        return min(ok, key=lambda i: self.points[i]["norm_area"])

    def ptrees(self) -> list:
        """Rebuild the per-tree `ParallelTree`s from the stored layout.

        The same block-diagonal slicing as `search.problem_ptrees`, driven
        from the artifact's arrays instead of a `SearchProblem` — the
        hardware pipeline (netlist build, RTL emission) and the serving
        runtime re-materialize a design from the JSON alone.
        """
        ptrees, n_off, l_off = [], 0, 0
        for n_k, l_k in zip(self.tree_comparators, self.tree_leaves):
            block = self.path[l_off:l_off + l_k, n_off:n_off + n_k]
            if n_k == 0:  # single-leaf tree: ParallelTree keeps a dummy col
                block = np.zeros((l_k, 1), np.int8)
            ptrees.append(ParallelTree(
                feature=self.feature[n_off:n_off + n_k],
                threshold=self.threshold[n_off:n_off + n_k],
                path=np.ascontiguousarray(block),
                path_len=self.path_len[l_off:l_off + l_k],
                n_neg=self.n_neg[l_off:l_off + l_k],
                leaf_class=self.leaf_class[l_off:l_off + l_k],
                n_classes=self.n_classes,
            ))
            n_off += n_k
            l_off += l_k
        return ptrees


def from_payload(payload: dict, where: str = "payload"):
    """Validate a payload dict and materialize the family's artifact.

    Legacy payloads (no `family` key) and `family: "tree"` ones validate
    against the tree schema here; any other family tag dispatches to that
    family's own loader, so every consumer of `load_pareto_artifact`
    handles MLP artifacts too (an unknown tag raises `ValueError`).
    """
    if isinstance(payload, dict) and payload.get("family", "tree") != "tree":
        from repro_torch.families import family_of_payload
        return family_of_payload(payload).load_artifact(payload)
    validate_payload(payload, where)
    return ParetoArtifact(
        payload=payload,
        feature=np.asarray(payload["feature"], np.int32),
        threshold=np.asarray(payload["threshold"], np.float32),
        path=np.asarray(payload["path"], np.int8),
        path_len=np.asarray(payload["path_len"], np.int32),
        n_neg=np.asarray(payload["n_neg"], np.int32),
        leaf_class=np.asarray(payload["leaf_class"], np.int32),
        n_trees=int(payload["n_trees"]),
        n_classes=int(payload["n_classes"]),
        tree_comparators=tuple(payload["tree_comparators"]),
        tree_leaves=tuple(payload["tree_leaves"]),
        exact_accuracy=float(payload["exact_accuracy"]),
        exact_area_mm2=float(payload["exact_area_mm2"]),
        dataset=payload.get("dataset"),
        points=list(payload["pareto"]),
    )


def load_pareto_artifact(path: str):
    """Load + validate a `pareto.json` (any family, dispatched by tag)."""
    with open(path) as f:
        payload = json.load(f)
    return from_payload(payload, where=path)
