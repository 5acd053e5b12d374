"""Carry state from numpy arrays into the port's objects.

The tests run the JAX package and the port on identical inputs: they read
a JAX `SearchProblem`, `MLPProblem`, `NSGA2State` or LM parameter tree out
as numpy arrays and rebuild the port's counterpart here. (`pareto.json`
carries a design in both directions.) Nothing here imports the JAX
package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import area as area_mod
from repro_torch.core.nsga2 import NSGA2State
from repro_torch.device import resolve_device
from repro_torch.search.problem import SearchProblem

_PROBLEM_ARRAYS = {
    "feature": torch.int32, "threshold": torch.float32, "path": torch.int8,
    "path_len": torch.int32, "n_neg": torch.int32, "leaf_class": torch.int32,
    "leaf_tree": torch.int32, "x8": torch.int32, "x_sel": torch.int32,
    "y": torch.int32,
}


def problem_from_arrays(fields: dict, scalars: dict,
                        device="cuda") -> SearchProblem:
    """The port's `SearchProblem` from a JAX `SearchProblem`'s fields.

    ``fields``: numpy arrays named as the JAX fields (feature, threshold,
    path, path_len, n_neg, leaf_class, leaf_tree, x8, x_sel, y, area_lut,
    lut_offsets); ``scalars``: overhead_mm2, exact_accuracy, n_classes,
    n_features, n_trees, tree_comparators, tree_leaves and, for a forest,
    vote_mm2_exact and vote_mm2_approx. The float mm^2 LUT, overhead and
    vote adders are converted to the integer quanta the port scores in
    (they must be whole quanta), and the exact design's area is recomputed
    in quanta.
    """
    dev = resolve_device(device)
    q = area_mod.AREA_QUANTUM_MM2
    units = np.asarray(fields["area_lut"], np.float64) / q
    overhead = float(scalars["overhead_mm2"]) / q
    votes = [float(scalars.get(k, 0.0)) / q
             for k in ("vote_mm2_exact", "vote_mm2_approx")]
    if (np.abs(units - np.round(units)).max(initial=0) > 1e-3
            or any(abs(v - round(v)) > 1e-6 for v in (overhead, *votes))):
        raise ValueError("area LUT / overhead / vote adders are not whole "
                         "area quanta")
    units = np.round(units).astype(np.int32)
    offsets = np.asarray(fields["lut_offsets"], np.int64)
    t = {k: torch.as_tensor(np.array(fields[k]), device=dev).to(dt)
         for k, dt in _PROBLEM_ARRAYS.items()}
    t8 = np.clip(np.floor(np.asarray(fields["threshold"], np.float64) * 256.0),
                 0, 255).astype(np.int64)
    exact_units = (int(units[offsets[8] + t8].astype(np.int64).sum())
                   + int(round(overhead)) + int(round(votes[0])))
    return SearchProblem(
        **t,
        area_units=torch.as_tensor(units, device=dev),
        lut_offsets=torch.as_tensor(offsets, device=dev),
        overhead_units=int(round(overhead)),
        exact_units=exact_units,
        exact_accuracy=float(scalars["exact_accuracy"]),
        n_classes=int(scalars["n_classes"]),
        n_features=int(scalars["n_features"]),
        n_trees=int(scalars["n_trees"]),
        tree_comparators=tuple(int(v) for v in scalars["tree_comparators"]),
        tree_leaves=tuple(int(v) for v in scalars["tree_leaves"]),
        vote_units_exact=int(round(votes[0])),
        vote_units_approx=int(round(votes[1])),
    )


def nsga2_state_from_arrays(fields: dict, device="cuda") -> NSGA2State:
    """The port's `NSGA2State` from numpy arrays genes (P, G), objs (P, M),
    rank (P,), crowd (P,) and the scalar generation (the JAX key stays
    behind: the port draws from a `torch.Generator`)."""
    dev = resolve_device(device)

    def t(name, dtype):
        return torch.as_tensor(np.array(fields[name]), device=dev).to(dtype)

    return NSGA2State(
        genes=t("genes", torch.float32),
        objs=t("objs", torch.float32),
        rank=t("rank", torch.int32),
        crowd=t("crowd", torch.float32),
        generation=int(fields["generation"]),
    )


def mlp_problem_from_arrays(w1_master, w2_master, shift: int, n_classes: int,
                            x8, y, device="cuda"):
    """The port's printed-MLP problem from a JAX `MLPProblem`'s masters:
    ``w1_master`` (F, H) / ``w2_master`` (H, C) int codes in [-8, 7], the
    static ReLU ``shift``, the test codes ``x8`` (B, F) and labels ``y``.
    The decode tables, the exact accuracy and the exact area are recomputed
    in the port, so both packages score the same weights."""
    from repro_torch.families import printed_mlp

    return printed_mlp.problem_from_masters(w1_master, w2_master, shift,
                                            n_classes, x8, y, device=device)


def lm_params_from_arrays(params_np: dict, cfg, device="cuda") -> dict:
    """The port's LM parameters from a JAX `transformer.init_params` tree
    read out as numpy arrays: ``embed``, ``final_norm``, the stacked
    ``layers`` (ln1, attn {wq, wk, wv, wo}, ln2, ffn {wi, [wg,] wo}) and
    ``lm_head`` when the embeddings are not tied. The port keeps the same
    tree, so the mapping is one to one; each array becomes a tensor of the
    config's dtype on ``device`` (bfloat16 arrays pass through float32,
    which holds them exactly)."""
    from repro_torch.models import transformer

    transformer.require_attn_mlp(cfg)
    dev = resolve_device(device)
    dtype = transformer.torch_dtype(cfg)
    want = {"embed", "final_norm", "layers"} | (
        set() if cfg.tie_embeddings else {"lm_head"})
    if set(params_np) != want:
        raise ValueError(f"lm_params_from_arrays: keys {sorted(params_np)}, "
                         f"expected {sorted(want)} for {cfg.name}")

    def convert(tree):
        if isinstance(tree, dict):
            return {k: convert(v) for k, v in tree.items()}
        return torch.as_tensor(np.array(tree, np.float32)).to(
            device=dev, dtype=dtype)

    return convert(params_np)
