"""Parameter / optimizer-state / batch / cache layouts over a mesh.

Counterpart of `repro.sharding.params`, with the same rules: a dim is
sharded over a mesh-axis group only when its size divides the group's
size, otherwise it stays replicated. A spec is a tuple with one entry per
dim (None, an axis name, or a tuple of axis names), as the JAX package's
`PartitionSpec` has, and the functions return the JAX package's trees
entry for entry (an unsharded leaf's spec is ``()`` where the JAX package
writes ``P()``). They take a mesh shape (`rules.mesh_axes`: a dict or
anything with one), so the 16x16 and 2x16x16 production trees can be
computed with no ranks at all; the parameter shapes come from
`transformer.param_shapes` on the meta device.

A rank's shard of a leaf (`shard`) cuts each sharded dim into equal blocks
and keeps block i, where i is the rank's index along the dim's axes in
order, the first axis the major one: JAX's order, so `gather` (one
`all_gather` an axis, the last axis first) rebuilds the leaf.
`shard_tree` / `gather_tree` do that for a tree and its spec tree;
`init_sharded_params` draws the full leaves one subtree at a time on every
rank (the single-device numbers) and keeps each rank's shard;
`local_shape` gives a shard's shape without data.
"""
from __future__ import annotations

import math

import torch

from repro_torch import pytree
from repro_torch.models import transformer
from repro_torch.sharding.rules import MeshRules, head_sharding, mesh_axes


def _axes_size(ms: dict, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return ms[axes]
    return math.prod(ms[a] for a in axes)


def _axis_if(size: int, axes, ms: dict):
    if axes is None:
        return None
    n = _axes_size(ms, axes)
    if n > 1 and size % n == 0:
        return axes if isinstance(axes, str) else tuple(axes)
    return None


def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry, in order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> set:
    """Every mesh axis a spec names."""
    return {a for e in spec for a in entry_axes(e)}


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def _map_specs(fn, specs, *trees):
    """A new tree of ``fn(spec, *leaves)`` over a spec tree and trees of
    the same structure (specs are tuples, so they are its leaves)."""
    if isinstance(specs, dict):
        return {k: _map_specs(fn, specs[k], *(t[k] for t in trees))
                for k in specs}
    return fn(specs, *trees)


def param_specs(cfg, rules: MeshRules | None, mesh) -> dict:
    """Spec tree matching `transformer.init_params(cfg)`."""
    shapes = transformer.param_shapes(cfg)
    if rules is None:
        return pytree.tree_map(lambda _: (), shapes)
    ms = mesh_axes(mesh)
    mode, _ = head_sharding(cfg, rules)
    mdl = rules.model

    if cfg.n_experts:      # must mirror models.moe._ep_mode
        import dataclasses

        from repro_torch.models.moe import _ep_mode
        if _ep_mode(cfg, dataclasses.replace(rules, mesh=ms)) == "alltoall":
            ex_ax, eff_ax = rules.expert, rules.model
        else:
            ex_ax, eff_ax = None, rules.ff_wide
    else:
        ex_ax, eff_ax = None, None
    # weights that cannot shard over the model axis fall back to
    # ZeRO-3-style sharding of the d_model dim over 'data' (gathered on use)
    zero_ax = rules.batch[-1] if rules.batch else None

    def spec_for(path, leaf):
        name = pytree.path_str(path)
        shp = leaf.shape
        last = path[-1]

        def build(base_ndim, entries):
            return tuple([None] * (len(shp) - base_ndim) + list(entries))

        if last in ("embed", "lm_head"):
            return (_axis_if(shp[0], mdl, ms), None)
        if "attn" in name:
            if last in ("wq", "wk", "wv"):
                ax = _axis_if(shp[-2], mdl, ms) if mode == "sharded" else None
                d_ax = None if ax else _axis_if(shp[-3], zero_ax, ms)
                return build(3, [d_ax, ax, None])
            if last == "wo":
                ax = _axis_if(shp[-3], mdl, ms) if mode == "sharded" else None
                d_ax = None if ax else _axis_if(shp[-1], zero_ax, ms)
                return build(3, [ax, None, d_ax])
        if "ffn" in name and cfg.n_experts:
            if last in ("wi", "wg"):
                return build(3, [_axis_if(shp[-3], ex_ax, ms), None,
                                 _axis_if(shp[-1], eff_ax, ms)])
            if last == "wo":
                return build(3, [_axis_if(shp[-3], ex_ax, ms),
                                 _axis_if(shp[-2], eff_ax, ms), None])
            if last == "router":
                return build(2, [_axis_if(shp[-2], zero_ax, ms), None])
        if "ffn" in name:
            if last in ("wi", "wg"):
                return build(2, [None, _axis_if(shp[-1], mdl, ms)])
            if last == "wo":
                return build(2, [_axis_if(shp[-2], mdl, ms), None])
        if "ssm" in name:
            if last in ("z_proj", "x_proj", "dt_proj", "conv_x_w"):
                return build(2, [None, _axis_if(shp[-1], mdl, ms)])
            if last == "out_proj":
                return build(2, [_axis_if(shp[-2], mdl, ms), None])
        return (None,) * len(shp)

    specs = pytree.tree_map(lambda _: None, shapes)
    for path, leaf in pytree.leaves_with_paths(shapes):
        pytree.put(specs, path, spec_for(path, leaf))
    return specs


def zero1_spec(spec: tuple, shape, rules: MeshRules | None, ms: dict):
    """ZeRO-1: ``spec`` with its largest still-unsharded dim that the
    data axis (the last batch axis) divides sharded over it; ``spec``
    itself when the data axis is in use already or nothing divides."""
    zero_ax = rules.batch[-1] if (rules and rules.batch) else None
    if rules is None or zero_ax is None:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if zero_ax in spec_axes(entries):
        return spec
    for i in sorted(range(len(entries)), key=lambda i: -shape[i]):
        if entries[i] is None and shape[i] % ms[zero_ax] == 0 \
                and shape[i] >= ms[zero_ax]:
            entries[i] = zero_ax
            return tuple(entries)
    return spec


def opt_state_specs(cfg, rules, mesh, optimizer_name: str) -> dict:
    """Optimizer-state specs: AdamW's moments the param specs plus ZeRO-1
    (`zero1_spec`), so float32 moments cost at most params/|data| a rank;
    Adafactor's factored moments the param specs with the last entry
    (``vr``) or the second-to-last (``vc``) dropped."""
    pspecs = param_specs(cfg, rules, mesh)
    if optimizer_name == "adamw":
        shapes = transformer.param_shapes(cfg)
        ms = mesh_axes(mesh) if rules is not None else {}
        z1 = _map_specs(lambda s, leaf: zero1_spec(s, leaf.shape, rules, ms),
                        pspecs, shapes)
        return {"m": z1, "v": z1}

    def factored(spec):
        if len(spec) >= 2:
            return {"vr": spec[:-1], "vc": spec[:-2] + spec[-1:]}
        return {"v": spec}

    return _map_specs(factored, pspecs)


def train_state_specs(cfg, rules, mesh, optimizer_name: str):
    from repro_torch.runtime.train import TrainState

    return TrainState(params=param_specs(cfg, rules, mesh),
                      opt_state=opt_state_specs(cfg, rules, mesh,
                                                optimizer_name),
                      step=())


def batch_specs(cfg, rules, mesh, batch: dict) -> dict:
    """Input batch specs: the batch dim over the data axes when divisible."""
    if rules is None:
        return pytree.tree_map(lambda _: (), batch)
    ms = mesh_axes(mesh)

    def one(leaf):
        ax = _axis_if(leaf.shape[0], rules.batch, ms)
        return (ax,) + (None,) * (len(leaf.shape) - 1)

    return pytree.tree_map(one, batch)


def cache_specs(cfg, rules, mesh, caches: dict) -> dict:
    """Decode-cache specs: the KV cache's batch over the data axes and its
    SEQUENCE over the model axis (context-parallel decode: any KV head
    count, no repeat); SSM conv caches batch-sharded; SSM states
    (L, B, NH, HD, N) batch- and head-sharded."""
    if rules is None:
        return pytree.tree_map(lambda _: (), caches)
    ms = mesh_axes(mesh)

    def one(leaf):
        shp = leaf.shape
        if len(shp) == 5 and cfg.ssm_state and shp[-1] == cfg.ssm_state:
            return (None, _axis_if(shp[1], rules.batch, ms),
                    _axis_if(shp[2], rules.model, ms), None, None)
        if len(shp) == 5:   # kv cache (L, B, S_max, KV, hd)
            return (None, _axis_if(shp[1], rules.batch, ms),
                    _axis_if(shp[2], rules.model, ms), None, None)
        if len(shp) == 4:   # ssm conv (L, B, K-1, C)
            return (None, _axis_if(shp[1], rules.batch, ms), None, None)
        return (None,) * len(shp)

    return pytree.tree_map(one, caches)


def check_serve(rules: MeshRules, mesh, s_max: int | None = None) -> None:
    """Sharded serving's one refused shape: the cache's ``s_max`` slots
    over the model axis (context-parallel decode); a `ValueError` where
    they do not divide. (A global batch that does not divide over the
    batch axes is replicated over them, as `cache_specs` writes it:
    `serve_rows`.)"""
    tp = mesh_axes(mesh).get(rules.model, 1)
    if s_max is not None and s_max % tp:
        raise ValueError(f"sharded serving shards the cache's s_max={s_max} "
                         f"slots over the {tp} model ranks (context-parallel "
                         f"decode); it does not divide")


def serve_rows(rules: MeshRules, mesh, batch: int) -> int:
    """A rank's rows of a served global ``batch``: its block over the batch
    axes where the batch divides over them, else the whole batch (the JAX
    package's GSPMD replicates a dim that does not divide,
    `batch_specs` / `cache_specs`), so every rank of those axes holds and
    computes every row."""
    dp = _axes_size(mesh_axes(mesh), tuple(rules.batch))
    return batch if batch % dp else batch // dp


def cache_blocks(cfg, rules: MeshRules, caches: dict, mesh) -> dict:
    """This rank's blocks of whole decode caches (`models.lm.init_caches`'s
    layout, the JAX package's): each leaf cut under `cache_specs` (the KV
    caches' batch over the batch axes and their slots over ``model``, the
    SSM states' batch and heads), except the SSM conv cache (L, B, K-1,
    d_inner + 2N), which `cache_specs` replicates over ``model``: a rank
    keeps its batch rows of [its d_inner/tp x channels | B | C], what the
    sharded Mamba2 block computes (`models.ssm.ssm_block_sharded`). A batch
    that does not divide over the batch axes is replicated (every rank
    keeps every row); an s_max that does not divide over ``model`` is
    refused (`check_serve`)."""
    kv = caches.get("kv", caches.get("shared_kv"))
    check_serve(rules, mesh, s_max=kv[0].shape[2] if kv else None)
    out = _map_tree(lambda leaf, spec: shard(leaf, spec, mesh), caches,
                    cache_specs(cfg, rules, mesh, caches))
    if "ssm" in out:
        conv, state = out["ssm"]
        di = cfg.d_inner
        di_l = di // rules.tp
        m = mesh.get_local_rank(rules.model)
        out["ssm"] = (torch.cat([conv[..., m * di_l:(m + 1) * di_l],
                                 conv[..., di:]], dim=-1), state)
    return out


def gather_caches(cfg, rules: MeshRules, blocks: dict, mesh,
                  batch: int | None = None) -> dict:
    """The whole decode caches, in the JAX package's layout, from every
    rank's `cache_blocks` (every rank gets them): the conv caches' x
    channels gathered over ``model``, then every leaf under
    `cache_specs`. ``batch`` is the global batch, by default the blocks'
    rows times the batch ranks; a batch the batch axes replicate
    (`serve_rows`) must be given, since its blocks' rows alone do not
    tell it from a sharded one."""
    from repro_torch.core import comm

    out = dict(blocks)
    ms = mesh_axes(mesh)
    if "ssm" in out:
        conv, state = out["ssm"]
        di_l = cfg.d_inner // rules.tp
        x = comm.all_gather_cat(conv[..., :di_l].contiguous(),
                                mesh.get_group(rules.model), 3)
        out["ssm"] = (torch.cat([x, conv[..., di_l:]], dim=-1), state)
    kv = out.get("kv", out.get("shared_kv"))
    if batch is None:
        lead = (kv or out["ssm"])[0]
        batch = lead.shape[1] * _axes_size(ms, tuple(rules.batch))
    s_max = kv[0].shape[2] * ms[rules.model] if kv else ms[rules.model]
    specs = cache_specs(cfg, rules, mesh, transformer.empty_caches(
        cfg, batch, s_max, torch.float32, "meta"))   # the whole caches'
    return _map_tree(lambda leaf, spec: gather(leaf, spec, mesh), out, specs)


# ---------------------------------------------------------------------------
# shards
# ---------------------------------------------------------------------------

def _block(mesh, axes: tuple) -> tuple[int, int]:
    """(block index, block count) of a dim sharded over ``axes`` in order,
    the first axis the major one; ``mesh`` a `DeviceMesh` or a stand-in
    with ``shape`` and ``get_local_rank``."""
    sizes = mesh_axes(mesh)
    idx, n = 0, 1
    for a in axes:
        idx = idx * sizes[a] + mesh.get_local_rank(a)
        n *= sizes[a]
    return idx, n


def shard(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``, a contiguous copy that
    holds no more than the block (or ``t`` itself when the spec shards
    nothing)."""
    whole = t
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes:
            continue
        idx, n = _block(mesh, axes)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {t.shape[dim]} does not "
                             f"divide over {axes} ({n} ranks)")
        b = t.shape[dim] // n
        t = t.narrow(dim, idx * b, b)
    if t is whole:
        return t.contiguous()
    # a block of leading rows is a contiguous view that would pin the
    # whole leaf's storage
    return t.clone(memory_format=torch.contiguous_format)


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """The shape of a rank's block of a ``shape`` leaf under ``spec``."""
    sizes = mesh_axes(mesh)
    out = list(shape)
    for dim, entry in enumerate(spec):
        out[dim] //= math.prod(sizes[a] for a in entry_axes(entry))
    return tuple(out)


def gather(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole leaf from every rank's block under ``spec`` (every rank
    gets it): an `all_gather` along each sharded dim, over each of its
    axes, the last axis first."""
    from repro_torch.core import comm

    for dim, entry in enumerate(spec):
        for a in reversed(entry_axes(entry)):
            t = comm.all_gather_cat(t, mesh.get_group(a), dim)
    return t


def shard_tree(full_tree, specs, mesh):
    """A tree of this rank's blocks of ``full_tree``'s leaves under the
    matching ``specs`` (a `runtime.train.TrainState` becomes one of its
    shards, its step kept)."""
    return _map_tree(lambda leaf, spec: shard(leaf, spec, mesh),
                     full_tree, specs)


def gather_tree(local_tree, specs, mesh):
    """The whole leaves of a tree of this rank's blocks, one leaf at a
    time (every rank gets them)."""
    return _map_tree(lambda leaf, spec: gather(leaf, spec, mesh),
                     local_tree, specs)


def _map_tree(fn, tree, specs):
    from repro_torch.runtime.train import TrainState

    if isinstance(tree, TrainState):
        return TrainState(_map_tree(fn, tree.params, specs.params),
                          _map_tree(fn, tree.opt_state, specs.opt_state),
                          fn(tree.step, specs.step))
    if isinstance(tree, dict):
        return {k: _map_tree(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, (tuple, list)) and not _is_spec(tree):
        return type(tree)(_map_tree(fn, t, s) for t, s in zip(tree, specs))
    return fn(tree, specs)


def init_sharded_params(seed: int, cfg, rules: MeshRules, mesh,
                        device="cuda", dtype: torch.dtype | None = None):
    """This rank's shards of `transformer.init_params(seed, cfg)`: every
    rank draws each subtree whole from the same generator, on ``device``,
    and keeps its blocks at once, so the shards equal the single-device
    parameters sliced, and no rank holds more than one full subtree."""
    specs = param_specs(cfg, rules, mesh)
    return transformer.init_params(
        seed, cfg, dtype, device=device,
        take=lambda path, tree: shard_tree(tree, pytree.get(specs, path),
                                           mesh))
