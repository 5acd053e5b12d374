"""What a rank of the sharded train step knows about its layout.

The port runs the JAX package's sharded LM step as explicit per-rank SPMD
(`sharding.rules`): each rank holds its block of every leaf under
`sharding.params.param_specs`, and the layer code calls named collectives
(`core.comm`) on the mesh's axis groups. A `Layout` gathers what that code
needs: the groups, this rank's index on the model axis, the attention's
head mode, and `weight`, which turns a rank's block of a leaf into the
tensor the layer multiplies by:

- a dim sharded over ``data`` (ZeRO-3: attention weights whose heads do
  not shard over ``model``) is gathered over ``data`` on use, and its
  gradient reduce-scattered back (`comm.gather_along`);
- a leaf replicated over ``model`` (norm scales, replicated attention
  weights, the repeated KV weights) is used by every model rank on its own
  sequence positions or heads, so each rank's gradient is a partial sum:
  `comm.copy_to_group` sums it over ``model`` in the backward. That is the
  step of Megatron's sequence parallelism most often missed.

The residual stream is sequence-sharded over ``model`` between blocks
(Megatron SP, the JAX package's ``rules.seq``); a block gathers it along
the sequence for its tensor-parallel products and reduce-scatters their
partial sums back. So the sequence length must divide over ``model``, the
vocabulary (its padded size) and d_ff too: `Layout.check_widths` and
`check_seq` raise otherwise. The JAX package also runs a replicated residual and replicated
d_ff or vocab; the port does not, and no config of the repo needs it at
its production tp.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import comm
from repro_torch.models.transformer import layer_kind
from repro_torch.sharding import params as sp
from repro_torch.sharding.rules import MeshRules, head_sharding, mesh_axes


@dataclasses.dataclass(frozen=True)
class Layout:
    cfg: object
    rules: MeshRules
    mesh: object
    specs: dict            # param spec tree (stacked leaves)
    mode: str              # head_sharding's mode
    kv_repeat: int
    tp: int
    model_rank: int
    model_group: object
    batch_groups: tuple    # one group per batch axis

    @classmethod
    def build(cls, cfg, rules: MeshRules) -> "Layout":
        if layer_kind(cfg) != "attn_mlp":
            raise NotImplementedError(
                f"the sharded train step runs the attn_mlp layer kind "
                f"(families dense, audio, vlm); {cfg.name} is "
                f"{layer_kind(cfg)}: its sharded forward is ROADMAP Queue 1 "
                f"item 13.5b")
        mesh = rules.mesh
        if mesh is None or not hasattr(mesh, "get_group"):
            raise ValueError("the sharded train step needs rules.mesh, the "
                             "DeviceMesh of its ranks (launch.mesh."
                             "rules_for)")
        sizes = mesh_axes(mesh)
        if sizes.get(rules.model, 1) != rules.tp:
            raise ValueError(f"rules.tp={rules.tp} but the mesh's "
                             f"{rules.model!r} axis has "
                             f"{sizes.get(rules.model, 1)} ranks")
        mode, kv_repeat = head_sharding(cfg, rules)
        lay = cls(cfg, rules, mesh, sp.param_specs(cfg, rules, sizes), mode,
                  kv_repeat, rules.tp, mesh.get_local_rank(rules.model),
                  mesh.get_group(rules.model),
                  tuple(mesh.get_group(a) for a in rules.batch))
        lay.check_widths()
        return lay

    def check_widths(self) -> None:
        cfg = self.cfg
        for what, n in (("the padded vocabulary", cfg.padded_vocab),
                        ("d_ff", cfg.d_ff)):
            if n % self.tp:
                raise ValueError(f"the sharded train step shards {what} "
                                 f"({n}) over the {self.tp} model ranks; "
                                 f"it does not divide")

    def check_seq(self, s: int) -> None:
        if s % self.tp:
            raise ValueError(f"the sharded train step shards the sequence "
                             f"({s} positions) over the {self.tp} model "
                             f"ranks (sequence parallelism); it does not "
                             f"divide")

    def layer_specs(self, key: str = "layers") -> dict:
        """The spec tree of one layer of the stacked ``key`` subtree (the
        layer axis dropped)."""
        return sp._map_specs(lambda s: s[1:], self.specs[key])

    def weight(self, w: torch.Tensor, spec: tuple) -> torch.Tensor:
        """The tensor a layer multiplies by, from this rank's block ``w``
        of a leaf laid out by ``spec`` (see the module docstring)."""
        for dim, entry in enumerate(spec):
            for a in reversed(sp.entry_axes(entry)):
                if a != self.rules.model:
                    w = comm.gather_along(w, self.mesh.get_group(a), dim)
        if self.rules.model not in sp.spec_axes(spec):
            w = comm.copy_to_group(w, self.model_group)
        return w


@functools.lru_cache(maxsize=8)
def layout(cfg, rules: MeshRules) -> Layout:
    """`Layout.build`, once for each (config, rules)."""
    return Layout.build(cfg, rules)
