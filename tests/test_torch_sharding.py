"""The port's sharding layout held to the JAX package's, with no ranks: the
spec trees of `repro_torch.sharding.params` (parameters, AdamW and
Adafactor state, the train state, batches, decode caches) equal
`repro.sharding.params`'s for every architecture on the 16x16 and 2x16x16
production meshes, entry for entry (both sides take a duck-typed mesh,
``types.SimpleNamespace(shape={...})``, so nothing is allocated);
`head_sharding` on those meshes and at tp 2, 3 and 4; `make_batch_specs`'s
shapes and dtypes; the production mesh refused on a group of the wrong
size; and `shard_tree` at every coordinate of a mesh rebuilding each leaf
(`gather_tree`'s order) on a reduced config. Tolerance: none; specs are
compared as tuples of axis names.

The JAX package is imported by a fixture, so the machine with the card
(which has no JAX) skips the parity tests.
"""
from __future__ import annotations

import itertools
import types

import numpy as np
import pytest
import torch

from repro_torch import pytree
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, reduced_config
from repro_torch.data import make_batch_specs
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import lm, transformer
from repro_torch.sharding import params as t_sp
from repro_torch.sharding import rules as t_rules

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
CACHE_BATCH, CACHE_SLOTS = 32, 4096


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.data import pipeline as j_data
    from repro.models import lm as j_lm
    from repro.sharding import params as j_sp
    from repro.sharding import rules as j_rules
    return types.SimpleNamespace(jax=jax, configs=configs, sp=j_sp,
                                 rules=j_rules, lm=j_lm, data=j_data)


def _rules(pair, name):
    """(JAX rules, port rules) of a production mesh."""
    j_rules, t_r = pair
    return (j_rules.RULES_3D, t_r.RULES_3D) if "pod" in MESHES[name] else \
        (j_rules.RULES_2D, t_r.RULES_2D)


def _norm(spec) -> tuple:
    """A spec with each one-axis tuple entry written as its axis name, the
    form newer JAX's `PartitionSpec` keeps (the two mean the same)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _flat(jx, tree) -> dict:
    """{path string: spec tuple} of a JAX spec tree."""
    P = jx.jax.sharding.PartitionSpec
    flat, _ = jx.jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): _norm(spec) for path, spec in flat}


def _flat_port(tree) -> dict:
    """{path string: spec tuple} of a port spec tree (a spec is a tuple of
    None, str or tuple entries, so it is read as a leaf)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, list) or (
                isinstance(node, tuple) and node
                and all(isinstance(e, tuple) for e in node)
                and not all(e is None or isinstance(e, str)
                            for e in node[0])):
            for i, child in enumerate(node):
                walk(child, path + (i,))
        else:
            out[pytree.path_str(path)] = _norm(node)
    walk(tree, ())
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_match_jax(jx, arch, mesh):
    """Parameters, AdamW (ZeRO-1) and Adafactor (factored) state, the train
    state, the train_4k batch and the decode caches."""
    ms = types.SimpleNamespace(shape=MESHES[mesh])
    j_r, t_r = _rules((jx.rules, t_rules), mesh)
    cfg_j, cfg_t = jx.configs.get_config(arch), get_config(arch)
    assert _flat_port(t_sp.param_specs(cfg_t, t_r, ms)) == \
        _flat(jx, jx.sp.param_specs(cfg_j, j_r, ms))
    for opt in ("adamw", "adafactor"):
        got = t_sp.train_state_specs(cfg_t, t_r, ms, opt)
        want = jx.sp.train_state_specs(cfg_j, j_r, ms, opt)
        assert _flat_port(got.opt_state) == _flat(jx, want.opt_state), opt
        assert _flat_port(got.params) == _flat(jx, want.params)
        assert tuple(got.step) == tuple(want.step)
    shape = SHAPES["train_4k"]
    assert _flat_port(t_sp.batch_specs(cfg_t, t_r, ms, make_batch_specs(
        cfg_t, shape))) == _flat(jx, jx.sp.batch_specs(
            cfg_j, j_r, ms, jx.data.make_batch_specs(cfg_j, shape)))
    caches_t = lm.init_caches(cfg_t, CACHE_BATCH, CACHE_SLOTS,
                              device="meta")
    caches_j = jx.jax.eval_shape(
        lambda: jx.lm.init_caches(cfg_j, CACHE_BATCH, CACHE_SLOTS))
    assert _flat_port(t_sp.cache_specs(cfg_t, t_r, ms, caches_t)) == \
        _flat(jx, jx.sp.cache_specs(cfg_j, j_r, ms, caches_j))


def test_spec_trees_without_rules_match_jax(jx):
    """rules=None: every leaf replicated, ``P()``."""
    cfg = get_config("llama3.2-3b")
    ms = types.SimpleNamespace(shape=MESHES["16x16"])
    assert _flat_port(t_sp.param_specs(cfg, None, ms)) == _flat(
        jx, jx.sp.param_specs(jx.configs.get_config("llama3.2-3b"), None,
                              ms))


@pytest.mark.parametrize("tp", [2, 3, 4, 16])
def test_head_sharding_matches_jax(jx, tp):
    for arch in ARCH_IDS:
        for cfg_t, cfg_j in ((get_config(arch),
                              jx.configs.get_config(arch)),
                             (reduced_config(get_config(arch)),
                              jx.configs.reduced_config(
                                  jx.configs.get_config(arch)))):
            got = t_rules.head_sharding(cfg_t, t_rules.MeshRules(tp=tp))
            want = jx.rules.head_sharding(cfg_j, jx.rules.MeshRules(tp=tp))
            assert got == want, (arch, tp)
    assert t_rules.head_sharding(get_config("llama3.2-3b"), None) == \
        ("replicated", 1)


def test_param_shapes_match_init_params():
    """The meta tree has init_params's structure, shapes and dtypes."""
    cfg = reduced_config(get_config("zamba2-7b"))
    real = transformer.init_params(0, cfg, device="cpu")
    meta = transformer.param_shapes(cfg)
    got = [(p, tuple(t.shape), t.dtype)
           for p, t in pytree.leaves_with_paths(meta)]
    want = [(p, tuple(t.shape), t.dtype)
            for p, t in pytree.leaves_with_paths(real)]
    assert got == want and all(t.is_meta for t in pytree.leaves(meta))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "paligemma-3b"])
def test_make_batch_specs_matches_jax(jx, arch):
    for name in ("train_4k", "prefill_32k"):
        got = make_batch_specs(get_config(arch), SHAPES[name])
        want = jx.data.make_batch_specs(jx.configs.get_config(arch),
                                        jx.configs.SHAPES[name])
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].is_meta
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert str(got[k].dtype).removeprefix("torch.") == \
                str(want[k].dtype)


@pytest.mark.parametrize("multi_pod,n", [(False, 256), (True, 512)])
def test_production_mesh_refuses_other_world_sizes(multi_pod, n):
    with pytest.raises(ValueError, match=rf"needs {n} ranks.* has 1"):
        t_mesh.make_production_mesh(multi_pod=multi_pod, device="cpu")


def test_rules_for_matches_jax_on_the_production_meshes(jx):
    """`launch.mesh.rules_for` equals the JAX package's on the production
    axis names (JAX's reads only ``mesh.axis_names``); on a (2, 2) mesh the
    two differ in ``tp`` alone: JAX keeps RULES_2D's 16, the port reads
    the mesh's model axis, 2."""
    import dataclasses

    from repro.launch import mesh as j_mesh

    def fields(r):
        return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)
                if f.name != "mesh"}

    for name, sizes in (*MESHES.items(), ("2x2", {"data": 2, "model": 2})):
        mesh = types.SimpleNamespace(axis_names=tuple(sizes), shape=sizes)
        got, want = fields(t_mesh.rules_for(mesh)), \
            fields(j_mesh.rules_for(mesh))
        if name == "2x2":
            assert (got.pop("tp"), want.pop("tp")) == (2, 16)
        assert got == want, name


class _NoRanks:
    """A mesh of the given axis sizes with no process group behind it:
    enough to build a `Layout` and have it refuse."""

    def __init__(self, **sizes):
        self.shape = sizes

    def get_group(self, axis):
        return None

    def get_local_rank(self, axis):
        return 0


@pytest.mark.parametrize("arch,over,what", [
    ("mamba2-1.3b", dict(d_model=63, ssm_expand=1, ssm_head_dim=21),
     "the SSM's d_inner \\(63\\) over the 2 model ranks"),
    ("mamba2-1.3b", dict(d_model=48, ssm_head_dim=32),
     "the SSM's heads \\(3\\) over the 2 model ranks"),
    ("kimi-k2-1t-a32b", dict(moe_d_ff=63),
     "the experts' d_ff \\(63\\) over the 2 model ranks"),
    ("grok-1-314b", dict(n_experts=3, moe_d_ff=66),
     "the experts' d_ff \\(66\\) over the 4 ranks of \\('data', 'model'\\)"),
    ("llama3.2-3b", dict(d_ff=129), "d_ff \\(129\\) over the 2 model ranks"),
])
def test_layout_refuses_widths_that_do_not_divide(arch, over, what):
    """Where GSPMD would replicate a dim that does not divide, the port's
    sharded step refuses it: the SSM's d_inner and heads over ``model``,
    the experts' d_ff over ``model`` ("alltoall", kimi's 4 experts over 2
    data ranks) or over every ``ff_wide`` axis ("gathered", 3 experts)."""
    from repro_torch.sharding.spmd import Layout

    cfg = reduced_config(get_config(arch), **over)
    rules = t_rules.MeshRules(tp=2, mesh=_NoRanks(data=2, model=2))
    with pytest.raises(ValueError, match=what):
        Layout.build(cfg, rules)


def test_layout_refuses_a_sequence_that_does_not_divide():
    from repro_torch.sharding.spmd import Layout

    cfg = reduced_config(get_config("llama3.2-3b"))
    lay = Layout.build(cfg, t_rules.MeshRules(
        tp=2, mesh=_NoRanks(data=2, model=2)))
    lay.check_seq(32)
    with pytest.raises(ValueError, match=r"sequence \(31 positions\) over "
                                         r"the 2 model ranks"):
        lay.check_seq(31)


def test_sharded_grads_refuse_rows_that_do_not_divide():
    """Each microbatch's rows are cut over the batch axes; 3 rows over 2
    data ranks raise before anything is computed."""
    from repro_torch.runtime import train

    cfg = reduced_config(get_config("llama3.2-3b"))
    rules = t_rules.MeshRules(tp=2, mesh=_NoRanks(data=2, model=2))
    grads_of = train.make_sharded_grads(cfg, rules, "adamw")
    with pytest.raises(ValueError, match=r"\('data',\) \(2 ranks\); tokens "
                                         r"has 3 rows"):
        grads_of({}, {"tokens": torch.zeros((3, 32), dtype=torch.int64)})


def test_rules_for_takes_the_mesh():
    for sizes, batch in (({"data": 2, "model": 4}, ("data",)),
                         ({"pod": 2, "data": 2, "model": 2},
                          ("pod", "data"))):
        r = t_mesh.rules_for(types.SimpleNamespace(shape=sizes))
        assert r.tp == sizes["model"] and r.batch == batch


class _Coords:
    """A rank's view of a mesh with no group: its index along each axis."""

    def __init__(self, sizes: dict, coords: dict):
        self.shape, self._coords = sizes, coords

    def get_local_rank(self, axis):
        return self._coords[axis]


@pytest.mark.parametrize("sizes", [{"data": 2, "model": 2},
                                   {"pod": 2, "data": 2, "model": 2}])
def test_shard_tree_blocks_rebuild_every_leaf(sizes):
    """Every coordinate's `shard_tree` of a reduced train state, put back
    along each sharded dim in `gather`'s order (the last axis of an entry
    innermost), is the state; ZeRO-1 moments hold 1/|data| of a leaf."""
    cfg = reduced_config(get_config("minitron-8b"), n_kv_heads=1)
    rules = t_rules.MeshRules(tp=sizes["model"],
                              batch=tuple(a for a in ("pod", "data")
                                          if a in sizes),
                              ff_wide=("data", "model"))
    specs = t_sp.train_state_specs(cfg, rules, sizes, "adamw")
    rng = np.random.default_rng(0)
    full = pytree.tree_map(
        lambda t: torch.as_tensor(rng.normal(size=t.shape).astype(
            np.float32)), {"params": transformer.param_shapes(cfg)})
    full["m"] = pytree.tree_map(torch.clone, full["params"])
    spec_tree = {"params": specs.params, "m": specs.opt_state["m"]}
    names = list(sizes)
    shards = {}
    for idx in itertools.product(*(range(sizes[a]) for a in names)):
        view = _Coords(sizes, dict(zip(names, idx)))
        shards[idx] = t_sp.shard_tree(full, spec_tree, view)
    flat_specs = _flat_port(spec_tree)
    for path, leaf in pytree.leaves_with_paths(full):
        spec = flat_specs[pytree.path_str(path)]
        rebuilt = torch.empty_like(leaf)
        for idx, tree in shards.items():
            view = _Coords(sizes, dict(zip(names, idx)))
            part = pytree.get(tree, path)
            assert tuple(part.shape) == t_sp.local_shape(leaf.shape, spec,
                                                         view)
            sl = []
            for dim, entry in enumerate(spec):
                b, n = t_sp._block(view, t_sp.entry_axes(entry))
                size = leaf.shape[dim] // n
                sl.append(slice(b * size, (b + 1) * size))
            rebuilt[tuple(sl)] = part
        assert torch.equal(rebuilt, leaf), pytree.path_str(path)
    zero = [p for p, s in flat_specs.items() if p.startswith("m/")
            and "data" in t_sp.spec_axes(s)]
    assert zero, "no moment is ZeRO-1 sharded"


def test_a_shard_holds_only_its_block():
    """A block of leading rows is a contiguous view of the leaf; `shard`
    copies it, so a rank's blocks do not pin the whole leaf's storage
    (the sharded init would keep every full embedding table)."""
    leaf = torch.arange(32.0).reshape(8, 4)
    for m in range(2):
        view = _Coords({"data": 2, "model": 2}, {"data": 0, "model": m})
        block = t_sp.shard(leaf, ("model", None), view)
        assert torch.equal(block, leaf[4 * m:4 * (m + 1)])
        assert block.untyped_storage().nbytes() == block.numel() * 4
    assert t_sp.shard(leaf, (None, None), view) is leaf


def test_leaves_with_paths_leaves_no_reference_cycle():
    """The walk keeps no cycle that holds the leaves after its caller drops
    them: a card's tensors would stay allocated until the cyclic collector
    ran (grok-1-314b's per-layer draws ran a card out of memory)."""
    import gc
    import weakref

    leaf = torch.zeros(3)
    ref = weakref.ref(leaf)
    gc.disable()
    try:
        got = pytree.leaves_with_paths({"a": {"b": leaf}})
        assert got == [(("a", "b"), leaf)]
        del got, leaf
        assert ref() is None
    finally:
        gc.enable()
