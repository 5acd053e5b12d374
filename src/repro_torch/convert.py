"""Carry state from numpy arrays into the port's objects.

The tests run the JAX package and the port on identical inputs: they read
a JAX `SearchProblem`, `MLPProblem`, `NSGA2State`, LM parameter tree or LM
`TrainState` out as numpy arrays and rebuild the port's counterpart here. (`pareto.json`
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


def lm_params_from_arrays(params_np: dict, cfg, device="cuda",
                          rules=None) -> dict:
    """The port's LM parameters from a JAX `transformer.init_params` tree
    read out as numpy arrays: ``embed``, ``final_norm``, the stacked
    ``layers`` (attn_mlp: ln1, attn {wq, wk, wv, wo}, ln2, ffn {wi, [wg,]
    wo}; attn_moe: the same with ffn {router, wi, [wg,] wo}; ssm: ln1, ssm
    {z_proj, ..., out_proj}), the hybrid's stacked ``shared`` attention +
    MLP blocks, and ``lm_head`` when the embeddings are not tied. The port
    keeps the same tree, so the mapping is one to one; each array becomes a
    tensor of its own width on ``device`` (bfloat16 arrays pass through
    float32, which holds them exactly), so the MoE ``router`` and the SSM's
    ``a_log``, ``d_skip`` and ``dt_bias`` stay float32 in a bfloat16 model,
    as the JAX package keeps them.

    With ``rules`` (bound to the mesh of the ranks), this rank's blocks of
    them under `sharding.params.param_specs`, on ``device``: the
    parameters the sharded serving and train steps take."""
    from repro_torch.models import transformer
    from repro_torch.models.common import is_glu

    dev = resolve_device(device)
    if rules is not None:
        from repro_torch import pytree
        from repro_torch.sharding import params as sp

        full = lm_params_from_arrays(params_np, cfg, "cpu")
        local = sp.shard_tree(full, sp.param_specs(
            cfg, rules, sp.mesh_axes(rules.mesh)), rules.mesh)
        return pytree.tree_map(lambda t: t.to(dev), local)
    want = {"embed", "final_norm", "layers"}
    if not cfg.tie_embeddings:
        want.add("lm_head")
    if cfg.family == "hybrid" and cfg.n_shared_blocks:
        want.add("shared")
    if set(params_np) != want:
        raise ValueError(f"lm_params_from_arrays: keys {sorted(params_np)}, "
                         f"expected {sorted(want)} for {cfg.name}")
    kind = transformer.layer_kind(cfg)
    if kind != "ssm":
        want_ffn = {"wi", "wo"} | ({"wg"} if is_glu(cfg.act) else set())
        if kind == "attn_moe":
            want_ffn.add("router")
        got_ffn = set(params_np["layers"].get("ffn", {}))
        if got_ffn != want_ffn:
            raise ValueError(f"lm_params_from_arrays: layers.ffn keys "
                             f"{sorted(got_ffn)}, expected {sorted(want_ffn)} "
                             f"for {cfg.name} ({kind})")

    def convert(tree):
        if isinstance(tree, dict):
            return {k: convert(v) for k, v in tree.items()}
        arr = np.asarray(tree)
        dtype = getattr(torch, str(arr.dtype))
        return torch.as_tensor(arr.astype(np.float32)).to(device=dev,
                                                          dtype=dtype)

    return convert(params_np)


def lm_caches_to_arrays(caches: dict, cfg, rules=None,
                        batch: int | None = None) -> dict:
    """Decode caches as numpy arrays in the JAX package's decode layout
    (`repro.models.lm.init_caches`'s tree: "kv", "ssm", "shared_kv", each
    a pair), float32: with ``rules``, gathered from every rank's blocks
    (`sharding.params.gather_caches`, the conv caches' channels put back
    in order; ``batch`` the global batch, which a replicated batch must
    give), which every rank of the mesh must call."""
    if rules is not None:
        from repro_torch.sharding import params as sp

        caches = sp.gather_caches(cfg, rules, caches, rules.mesh, batch)
    return {k: tuple(t.detach().cpu().float().numpy().copy() for t in pair)
            for k, pair in caches.items()}


def train_state_from_arrays(params_np: dict, opt_np: dict, step: int, cfg,
                            device="cuda", rules=None):
    """The port's `runtime.train.TrainState` from a JAX `TrainState` read out
    as numpy arrays: ``params_np`` as `lm_params_from_arrays` takes it,
    ``opt_np`` the optimizer state (AdamW: {"m": tree, "v": tree} like the
    params; Adafactor: a tree like the params whose leaves are {"vr", "vc"}
    or {"v"}), every array float32, and ``step`` the step count. The
    optimizer state's structure is checked against the params'.

    With ``rules`` (bound to the mesh of the ranks), this rank's blocks of
    that state under `sharding.params.train_state_specs`, on ``device``:
    the state the sharded train step takes."""
    from repro_torch import pytree
    from repro_torch.runtime.train import TrainState

    dev = resolve_device(device)
    if rules is not None:
        from repro_torch.sharding import params as sp

        full = train_state_from_arrays(params_np, opt_np, step, cfg, "cpu")
        specs = sp.train_state_specs(cfg, rules, sp.mesh_axes(rules.mesh),
                                     cfg.optimizer)
        local = sp.shard_tree(full, specs, rules.mesh)
        return TrainState(pytree.tree_map(lambda t: t.to(dev), local.params),
                          pytree.tree_map(lambda t: t.to(dev),
                                          local.opt_state),
                          local.step.to(dev))
    params = lm_params_from_arrays(params_np, cfg, device=dev)
    paths = [p for p, _ in pytree.leaves_with_paths(params)]
    if cfg.optimizer == "adafactor":
        for path in paths:
            got = set(pytree.get(opt_np, path))
            if got not in ({"vr", "vc"}, {"v"}):
                raise ValueError(f"train_state_from_arrays: Adafactor state "
                                 f"at {pytree.path_str(path)} has keys "
                                 f"{sorted(got)}")
    elif set(opt_np) != {"m", "v"} or any(
            [p for p, _ in pytree.leaves_with_paths(opt_np[k])] != paths
            for k in ("m", "v")):
        raise ValueError("train_state_from_arrays: AdamW state must be "
                         "{'m', 'v'} trees shaped like the params")
    opt = pytree.tree_map(
        lambda a: torch.as_tensor(np.array(a, np.float32)).to(dev), opt_np)
    return TrainState(params, opt,
                      torch.tensor(int(step), dtype=torch.int32, device=dev))
