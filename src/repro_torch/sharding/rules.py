"""Logical -> mesh sharding rules (DP / TP / SP / EP / pod).

Counterpart of `repro.sharding.rules`. One `MeshRules` instance fixes how
every logical tensor axis maps onto mesh axes. The production meshes
(`launch.mesh.make_production_mesh`) are:

  single-pod: (data=16, model=16)            RULES_2D
  multi-pod:  (pod=2, data=16, model=16)     RULES_3D

Logical axes:
  batch    -> all data-parallel axes (pod + data)
  model    -> tensor-parallel axis (heads / d_ff / vocab shards)
  expert   -> axes carrying the MoE expert dim (kimi: data; grok: none)
  ff_wide  -> extra axes for very wide expert d_ff (grok: data+model)
  seq      -> sequence-parallel axis for the residual stream (Megatron SP)

The JAX package states a layout and lets GSPMD insert the collectives;
its `maybe_shard` (a `with_sharding_constraint`, or nothing without rules)
is how layer code states it. The port runs explicit per-rank SPMD instead:
each rank holds its own shard of every leaf (`sharding.params`) and the
layer code calls named collectives on ``mesh.get_group(axis)``
(`core.comm`), so a layout is what the code computes and there is nothing
for `maybe_shard` to do. It is not ported.

``mesh`` is a `torch.distributed.device_mesh.DeviceMesh` or anything that
`mesh_axes` reads: a dict of axis sizes, or an object whose ``shape`` is
such a dict (the JAX package's `Mesh`, a `types.SimpleNamespace`).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MeshRules:
    tp: int                                  # size of the model axis
    batch: tuple[str, ...] = ("data",)
    model: str | None = "model"
    expert: tuple[str, ...] = ("data",)      # EP all-to-all dispatch axis
    ff_wide: tuple[str, ...] = ("data", "model")
    seq: str | None = "model"
    mesh: object = None                      # the DeviceMesh of the ranks

    def batch_spec(self) -> tuple:
        return self.batch if self.batch else None


RULES_1D = None  # one device: no rules

RULES_2D = MeshRules(tp=16, batch=("data",))

# experts dispatch across pods too (a2a over pod x data = 32-way)
RULES_3D = MeshRules(tp=16, batch=("pod", "data"),
                     expert=("pod", "data"),
                     ff_wide=("pod", "data", "model"))


def mesh_axes(mesh) -> dict:
    """{axis name: size} of ``mesh``: a `DeviceMesh` (its
    ``mesh_dim_names`` and ``shape``), a dict, or an object whose
    ``shape`` is a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def head_sharding(cfg, rules: MeshRules | None):
    """The attention head-sharding mode for this (arch, mesh).

    Returns (mode, kv_repeat):
      mode "sharded":   n_heads % tp == 0 — heads over the model axis; KV
                        heads repeated by kv_repeat so they divide tp too.
      mode "replicated": heads indivisible (paligemma/gemma 8H, llama 24H
                        at tp 16) — attention weights replicated over the
                        model axis.
    """
    if rules is None or cfg.n_heads == 0:
        return "replicated", 1
    tp = rules.tp
    if cfg.n_heads % tp == 0:
        group = cfg.n_heads // cfg.n_kv_heads
        r = 1
        while (cfg.n_kv_heads * r) % tp != 0 and r < group:
            r *= 2
        if (cfg.n_kv_heads * r) % tp == 0 and group % r == 0:
            return "sharded", r
    return "replicated", 1
