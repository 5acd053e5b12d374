"""What a rank of the sharded train and serving steps knows about its
layout.

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
partial sums back. Every layer kind runs so: `attn_mlp` (attention and
MLP), `ssm` (the Mamba2 block on the rank's channels and heads; the
hybrid's shared attention blocks too) and `attn_moe` (attention and the
expert-parallel MoE block, `models.moe.moe_block_sharded`). The MoE block
lays out its own expert weights, which `weight` would gather wrongly: in
"alltoall" mode each rank keeps its experts (the dispatch brings the
tokens to them) and its d_ff block over ``model``; in "gathered" mode
each rank gathers d_ff over every axis of ``rules.ff_wide``, ``model``
included. Its router goes through `weight`.

So the sequence length must divide over ``model``, and so must the
vocabulary (its padded size), d_ff, the SSM's d_inner and heads and, in
"alltoall" mode, the experts' d_ff; in "gathered" mode the experts' d_ff
must divide over the product of ``ff_wide``'s axes. `Layout.check_widths`
and `check_seq` raise otherwise. The JAX package would replicate such a
dim (GSPMD's fallback) and also runs a replicated residual; the port does
not, and no config of the repo needs it at its production tp.

Serving (`models.transformer.forward(rules=)`) keeps the prefill's
residual sequence-parallel as training does; a decode step's one-token
residual is whole on every model rank (the JAX package's), each block's
row-parallel partial sums all-reduced over ``model``. Its caches are a
rank's blocks (`sharding.params.cache_blocks`): the KV caches' slots over
``model`` (context-parallel decode), so s_max must divide over it too
(`sharding.params.check_serve`), and the batch over the batch axes where
it divides, every row on every rank of them where it does not
(`sharding.params.serve_rows`).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.distributed as dist

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
    ep_mode: str | None    # the MoE's expert-parallel mode (`moe._ep_mode`)
    expert_group: object   # the group of the expert axes' product, or None

    @classmethod
    def build(cls, cfg, rules: MeshRules) -> "Layout":
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
        ep_mode = None
        if cfg.n_experts:
            from repro_torch.models.moe import _ep_mode

            ep_mode = _ep_mode(cfg, rules)
        lay = cls(cfg, rules, mesh, sp.param_specs(cfg, rules, sizes), mode,
                  kv_repeat, rules.tp, mesh.get_local_rank(rules.model),
                  mesh.get_group(rules.model),
                  tuple(mesh.get_group(a) for a in rules.batch), ep_mode,
                  axes_group(mesh, rules.expert)
                  if ep_mode == "alltoall" else None)
        lay.check_widths()
        return lay

    def check_widths(self) -> None:
        cfg, kind = self.cfg, layer_kind(self.cfg)
        over = {"model": self.tp}
        widths = [("the padded vocabulary", cfg.padded_vocab, "model")]
        if kind == "attn_mlp" or cfg.family == "hybrid":
            widths.append(("d_ff", cfg.d_ff, "model"))
        if kind == "ssm":
            widths += [("the SSM's d_inner", cfg.d_inner, "model"),
                       ("the SSM's heads", cfg.ssm_nheads, "model")]
        if self.ep_mode == "alltoall":
            widths.append(("the experts' d_ff", cfg.moe_d_ff, "model"))
        elif self.ep_mode == "gathered":
            axes = tuple(self.rules.ff_wide)
            over[axes] = math.prod(sp.mesh_axes(self.mesh)[a] for a in axes)
            widths.append(("the experts' d_ff", cfg.moe_d_ff, axes))
        for what, n, axes in widths:
            ranks = over[axes]
            if n % ranks:
                where = (f"the {ranks} model ranks" if axes == "model" else
                         f"the {ranks} ranks of {axes}")
                raise ValueError(f"the sharded train step shards {what} "
                                 f"({n}) over {where}; it does not divide")

    def check_seq(self, s: int) -> None:
        if s % self.tp:
            raise ValueError(f"the sharded step shards the sequence "
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


def axes_group(mesh, axes: tuple):
    """The process group of the ranks that differ only along ``axes``
    (their product, the first axis the major one, as JAX orders a tuple
    of axis names): ``mesh.get_group(axis)`` for one axis, None for
    none. Every rank of the mesh must call this, in the same order, for
    several axes (each subgroup is made by every rank)."""
    axes = tuple(axes)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    names = list(mesh.mesh_dim_names)
    idx = [names.index(a) for a in axes]
    if idx != sorted(idx):
        # a group's ranks are ordered by global rank: the mesh's order
        raise ValueError(f"axes_group: {axes} are not in the mesh's order "
                         f"{tuple(names)}")
    rest = [i for i in range(len(names)) if i not in idx]
    n = math.prod(mesh.mesh.shape[i] for i in idx)
    mine = None
    for row in mesh.mesh.permute(*rest, *idx).reshape(-1, n).tolist():
        group = dist.new_group(row)
        if dist.get_rank() in row:
            mine = group
    return mine


@functools.lru_cache(maxsize=8)
def layout(cfg, rules: MeshRules) -> Layout:
    """`Layout.build`, once for each (config, rules)."""
    return Layout.build(cfg, rules)
