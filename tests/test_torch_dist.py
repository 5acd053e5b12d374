"""The port's multi-device search (`repro_torch.core.dist`, the engine's
mesh and islands paths, `run_sweep` on a mesh) on the CPU, over gloo
process groups of 2 and 4 ranks.

Each group is spawned once (`launch.mesh.spawn`) and runs every check of
its size; the tests then hold what the ranks return:

- `sharded_non_dominated_sort` against `repro.core.nsga2.non_dominated_sort`
  on pools of 64 to 1024 rows, ties included, rank for rank;
- `sharded_crowding_distance` against the single-device crowding;
- `make_sharded_chunk` on 2 and 4 ranks against `nsga2.make_chunk` from the
  same seed, on a seeds tree and a vertebral two-tree forest, the
  generator's state included;
- `_migrate` on 4 ranks against the JAX package's `dist._migrate` under
  `shard_map` on 4 forced host devices, run in a subprocess;
- the islands backend against `dist.run_islands_serial`, its resume, and
  the islands-family refusals;
- elastic resume, from a mesh to none and from none to a mesh;
- `run_sweep` on ``2x1`` and ``1x2`` meshes (and ``2x2`` on 4 ranks)
  against the serial oracle.

Tolerance: none. Integer arrays are equal, and float arrays are equal bit
for bit. The ranks import no JAX: this module imports it only inside the
parent's fixtures.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import search as t_search
from repro_torch.core import dist as t_dist
from repro_torch.core import nsga2 as t_nsga2
from repro_torch.launch import mesh as t_mesh

STATE = ("genes", "objs", "rank", "crowd")
POP, GENS, CHUNK_SEED = 16, 3, 7
POOLS = (64, 256, 1024)
SWEEP = dict(pop_size=8, n_generations=2, seed=1)


def _pool(p: int) -> np.ndarray:
    """Objectives on a coarse grid (many ties and duplicates)."""
    rng = np.random.default_rng(p)
    return (rng.integers(0, 8 if p < 1024 else 32, (p, 2)) / 7).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _problems():
    from repro_torch.families import get_family
    from repro_torch.search import sweep as t_sweep

    tree = get_family("tree")
    return {
        "seeds": tree.build_problem("seeds", device="cpu"),
        "forest": tree.build_problem("vertebral", n_trees=2, device="cpu"),
        "sweep": t_sweep.build_problems(["seeds", "vertebral"],
                                        mlp_datasets=["seeds"], n_hidden=4,
                                        device="cpu"),
    }


def _chunk_run(problem, mesh=None):
    """Init + GENS generations from CHUNK_SEED: (state, generator state),
    sharded over ``mesh`` (gathered back) or on one device."""
    fitness = t_search.make_fitness(problem, "kernel")
    cfg = t_nsga2.NSGA2Config(pop_size=POP)
    gen = torch.Generator().manual_seed(CHUNK_SEED)
    seeds = problem.exact_genes()
    if mesh is None:
        draws = t_nsga2.draw_init(gen, POP, problem.n_genes, 1, "cpu")
        state = t_nsga2.init_state(fitness, cfg, draws, seed_genes=seeds)
        state = t_nsga2.make_chunk(fitness, cfg, GENS)(state, gen)
    else:
        state = t_dist.init_sharded(gen, fitness, problem.n_genes, mesh,
                                    cfg, seed_genes=seeds)
        state = t_dist.make_sharded_chunk(fitness, mesh, cfg, GENS)(state,
                                                                    gen)
        state = t_dist.gather_state(state, mesh,
                                    t_dist.sharded_state_sharding(mesh))
    return state, gen.get_state()


def _search(problem, **kw):
    return t_search.run_search(problem, backend="kernel", pop_size=POP,
                               seed=3, checkpoint_every=2, **kw).state


def _islands(problem, **kw):
    return t_search.run_search(problem, backend="islands", pop_size=POP,
                               seed=5, migrate_every=2, n_migrate=3,
                               checkpoint_every=2, **kw).state


def _ranks(inputs: dict) -> dict:
    """Every check of one group, on this rank; returns what the parent
    holds to its oracles."""
    import torch.distributed as dist

    n = dist.get_world_size()
    probs = inputs["problems"]
    out = {}
    mesh = t_mesh.make_search_mesh(str(n), ("pop",), device="cpu")
    r, s = mesh.get_local_rank("pop"), None
    sorts, crowds = {}, {}
    for p, objs in inputs["pools"].items():
        full = torch.as_tensor(objs)
        s = p // n
        local = full[r * s:(r + 1) * s]
        rank = t_dist.sharded_non_dominated_sort(local, mesh)
        sorts[p] = t_dist.all_gather_cat(rank, mesh.get_group("pop"))
        crowd = t_dist.sharded_crowding_distance(local, rank, mesh)
        crowds[p] = t_dist.all_gather_cat(crowd, mesh.get_group("pop"))
    out["sorts"], out["crowds"] = sorts, crowds
    out["chunks"] = {name: _chunk_run(probs[name], mesh)
                     for name in ("seeds", "forest")}
    fit = t_search.make_fitness(probs["seeds"], "kernel")
    genes = torch.rand((POP, probs["seeds"].n_genes),
                       generator=torch.Generator().manual_seed(2))
    out["fitness"] = t_dist.sharded_fitness(fit, mesh)(genes)

    if n == 4:
        ring = t_mesh.make_search_mesh("4", ("data",), device="cpu")
        mig = inputs["migrate"]
        i, rows = ring.get_local_rank("data"), mig["genes"].shape[0] // 4
        state = t_nsga2.NSGA2State(*(
            torch.as_tensor(mig[f][i * rows:(i + 1) * rows]) for f in STATE),
            0)
        state = t_dist._migrate(state, ring.get_group("data"),
                                int(mig["n_migrate"]), 4)
        out["migrate"] = t_dist.gather_state(
            state, ring, t_dist.island_state_sharding(ring))
        out["sweep"] = {"2x2": _sweep_states(probs["sweep"], "2x2")}
        return out

    d = inputs["dirs"]
    seeds = probs["seeds"]
    out["resumed_onto_mesh"] = _search(seeds, n_generations=6, mesh="2",
                                       out_dir=d["none"], resume=True)
    _search(seeds, n_generations=4, mesh="2", out_dir=d["mesh"])
    out["islands"] = _islands(seeds, n_generations=4, mesh="2",
                              out_dir=d["islands"])
    _islands(seeds, n_generations=2, mesh="2", out_dir=d["islands_resume"])
    out["islands_resumed"] = _islands(seeds, n_generations=4, mesh="2",
                                      out_dir=d["islands_resume"],
                                      resume=True)
    ring = t_mesh.make_search_mesh("2", ("data",), device="cpu")
    state, _ = t_dist.run_islands(
        5, t_search.make_fitness(seeds, "reference"), seeds.n_genes, ring,
        _island_cfg(), 2, seed_genes=seeds.exact_genes(), device="cpu")
    out["run_islands"] = t_dist.gather_state(
        state, ring, t_dist.island_state_sharding(ring))
    out["pareto"] = t_dist.gathered_pareto(state, ring)
    out["sweep"] = {spec: _sweep_states(probs["sweep"], spec)
                    for spec in ("2x1", "1x2")}
    out["collectives"] = dict(t_dist.COLLECTIVES)
    return out


def _sweep_states(problems, mesh=None, vmapped=True):
    from repro_torch.search import sweep as t_sweep

    res = t_sweep.run_sweep(problems, mesh=mesh, vmapped=vmapped, **SWEEP)
    return {name: r.state for name, r in res.results.items()}


def _assert_states(a, b, what):
    for f in STATE:
        assert torch.equal(getattr(a, f), getattr(b, f)), (what, f)


def _jax_migrate(tmp_path, inputs: dict) -> dict:
    """The JAX package's `_migrate` under shard_map on 4 host devices."""
    np.savez(tmp_path / "mig_in.npz", **inputs)
    script = f"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from functools import partial
import numpy as np, jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import dist, nsga2
d = np.load({str(tmp_path / "mig_in.npz")!r})
mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
@partial(shard_map, mesh=mesh, in_specs=(P("data"),) * 4,
         out_specs=(P("data"),) * 4, check_rep=False)
def mig(g, o, r, c):
    s = nsga2.NSGA2State(g, o, r, c, jax.random.PRNGKey(0), jnp.int32(0))
    s = dist._migrate(s, "data", int(d["n_migrate"]), 4)
    return s.genes, s.objs, s.rank, s.crowd
out = jax.jit(mig)(*(jnp.asarray(d[f]) for f in
                     ("genes", "objs", "rank", "crowd")))
np.savez({str(tmp_path / "mig_out.npz")!r},
         **dict(zip(("genes", "objs", "rank", "crowd"), map(np.asarray, out))))
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", script], check=True, timeout=300,
                   env={**os.environ, "PYTHONPATH": os.path.join(repo, "src"),
                        "JAX_PLATFORMS": "cpu"})
    with np.load(tmp_path / "mig_out.npz") as out:
        return {f: out[f] for f in STATE}


def _migrate_inputs() -> dict:
    """Four islands of 12 rows: random genes, objectives on a grid, and
    their ranks and crowding from the single-device sort."""
    rng = np.random.default_rng(11)
    genes = rng.random((48, 5), dtype=np.float32)
    objs = (rng.integers(0, 6, (48, 2)) / 5).astype(np.float32)
    ranks, crowds = [], []
    for i in range(4):
        o = torch.as_tensor(objs[12 * i:12 * (i + 1)])
        rk = t_nsga2.non_dominated_sort(o)
        ranks.append(rk.numpy())
        crowds.append(t_nsga2.crowding_distance(o, rk).numpy())
    return dict(genes=genes, objs=objs, rank=np.concatenate(ranks),
                crowd=np.concatenate(crowds), n_migrate=np.int64(3))


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """The 2-rank group's results, and the single-device runs it is held
    to."""
    tmp = tmp_path_factory.mktemp("two")
    dirs = {k: str(tmp / k) for k in ("none", "mesh", "islands",
                                      "islands_resume")}
    probs = _problems()
    # the no-mesh run whose step-4 save the mesh resumes
    _search(probs["seeds"], n_generations=4, out_dir=dirs["none"])
    inputs = dict(problems=probs, dirs=dirs,
                  pools={p: _pool(p) for p in POOLS})
    return t_mesh.spawn(_ranks, 2, "cpu", (inputs,)), dirs


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("four")
    mig = _migrate_inputs()
    inputs = dict(problems=_problems(), pools={p: _pool(p) for p in POOLS},
                  migrate=mig)
    return t_mesh.spawn(_ranks, 4, "cpu", (inputs,)), _jax_migrate(tmp, mig)


def _group(request, n: int):
    return request.getfixturevalue("two" if n == 2 else "four")[0]


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_sort_matches_jax(request, n):
    from repro.core import nsga2 as j_nsga2

    for out in _group(request, n):
        for p in POOLS:
            want = np.asarray(j_nsga2.non_dominated_sort(_pool(p)))
            assert np.array_equal(out["sorts"][p].numpy(), want), p
            assert int(want.max()) >= 3   # several fronts to peel


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_crowding_is_bit_exact(request, n):
    for out in _group(request, n):
        for p in POOLS:
            objs = torch.as_tensor(_pool(p))
            want = t_nsga2.crowding_distance(
                objs, t_nsga2.non_dominated_sort(objs))
            assert torch.equal(out["crowds"][p], want), p


@pytest.mark.parametrize("name", ["seeds", "forest"])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_chunk_matches_make_chunk(request, n, name):
    want, want_rng = _chunk_run(_problems()[name])
    for out in _group(request, n):
        got, got_rng = out["chunks"][name]
        _assert_states(got, want, name)
        assert got.generation == want.generation == GENS
        assert torch.equal(got_rng, want_rng)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_fitness_reassembles_rows(request, n):
    problem = _problems()["seeds"]
    genes = torch.rand((POP, problem.n_genes),
                       generator=torch.Generator().manual_seed(2))
    want = t_search.make_fitness(problem, "kernel")(genes)
    for out in _group(request, n):
        assert torch.equal(out["fitness"], want)


def test_migrate_matches_jax(four):
    outs, want = four
    for out in outs:
        for f in STATE:
            assert np.array_equal(getattr(out["migrate"], f).numpy(),
                                  want[f]), f
    mig = _migrate_inputs()   # the elites moved: some rows changed
    assert not np.array_equal(want["genes"], mig["genes"])


def _island_cfg():
    """What `run_search(backend="islands")` makes of POP on 2 ranks."""
    return t_dist.IslandConfig(
        local_pop=POP // 2, migrate_every=2, n_migrate=3,
        nsga=t_nsga2.NSGA2Config(pop_size=POP // 2, n_generations=4))


def test_islands_match_the_serial_reference(two):
    outs, _ = two
    problem = _problems()["seeds"]
    states = t_dist.run_islands_serial(
        5, t_search.make_fitness(problem, "reference"), problem.n_genes, 2,
        _island_cfg(), 2, seed_genes=problem.exact_genes(), device="cpu")
    want = t_nsga2.NSGA2State(
        *(torch.cat([getattr(s, f) for s in states]) for f in STATE), 4)
    front = t_nsga2.pareto_front(want.objs, want.genes)
    for out in outs:
        _assert_states(out["islands"], want, "islands")
        _assert_states(out["run_islands"], want, "run_islands")
        assert out["islands"].generation == 4
        for got, exp in zip(out["pareto"], front):
            assert np.array_equal(got, exp)


def test_islands_resume_equals_the_uninterrupted_run(two):
    for out in two[0]:
        _assert_states(out["islands_resumed"], out["islands"], "resume")


@pytest.mark.parametrize("what", ["n_islands", "migrate_every",
                                  "single reads islands",
                                  "islands reads single"])
def test_islands_family_refusals(two, what):
    _, dirs = two
    seeds = _problems()["seeds"]
    if what == "n_islands":   # written on 2 ranks, resumed on 1 island
        args, match = dict(out_dir=dirs["islands"]), "on 2 islands"
    elif what == "migrate_every":
        args, match = (dict(out_dir=dirs["islands"], migrate_every=3),
                       "migrate_every=2")
    elif what == "single reads islands":
        args, match = dict(out_dir=dirs["islands"], backend="kernel"), \
            "'islands' driver"
    else:
        args, match = dict(out_dir=dirs["none"]), "'single' driver"
    kw = dict(backend="islands", pop_size=POP, n_generations=6,
              migrate_every=2, checkpoint_every=2, resume=True)
    kw.update(args)
    with pytest.raises(ValueError, match=match) as err:
        t_search.run_search(seeds, **kw)
    assert "\n" not in str(err.value)


@pytest.mark.parametrize("direction", ["none to mesh", "mesh to none"])
def test_elastic_resume(two, direction):
    outs, dirs = two
    seeds = _problems()["seeds"]
    want = _search(seeds, n_generations=6)
    if direction == "none to mesh":
        for out in outs:
            _assert_states(out["resumed_onto_mesh"], want, direction)
    else:
        got = _search(seeds, n_generations=6, out_dir=dirs["mesh"],
                      resume=True)
        _assert_states(got, want, direction)


def test_checkpoints_do_not_depend_on_the_mesh(two):
    from repro_torch.runtime import checkpoint

    _, dirs = two
    ref = _problems()["seeds"]
    like = t_search.engine._restore_template(
        ref, t_search.SearchConfig(pop_size=POP), torch.Generator())
    a, _ = checkpoint.restore(os.path.join(dirs["none"], "ckpt"), 4, like)
    b, _ = checkpoint.restore(os.path.join(dirs["mesh"], "ckpt"), 4, like)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("spec", ["2x1", "1x2", "2x2"])
def test_run_sweep_on_a_mesh_matches_the_serial_oracle(request, spec):
    outs = _group(request, 4 if spec == "2x2" else 2)
    want = _sweep_states(_problems()["sweep"], vmapped=False)
    for out in outs:
        got = out["sweep"][spec]
        assert sorted(got) == sorted(want)
        for name in want:
            _assert_states(got[name], want[name], (spec, name))


def test_run_sweep_mesh_needs_the_batched_path():
    with pytest.raises(ValueError, match="vmapped path"):
        _sweep_states(_problems()["sweep"], mesh="1", vmapped=False)


def test_sharded_step_counts_its_collectives(two):
    """Per rank the 2-rank group issued gathers and a reduction a front."""
    for out in two[0]:
        c = out["collectives"]
        assert c["all_gather"] > 0 and c["all_reduce"] > 0


def test_islands_config_defaults_match_jax():
    from repro.core import dist as j_dist

    j, t = j_dist.IslandConfig(), t_dist.IslandConfig()
    for f in ("local_pop", "migrate_every", "n_migrate"):
        assert getattr(j, f) == getattr(t, f)
    assert dataclasses.asdict(t.nsga) == {
        k: v for k, v in dataclasses.asdict(j.nsga).items()
        if k in dataclasses.asdict(t.nsga)}
