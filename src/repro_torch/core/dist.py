"""Multi-device NSGA-II: the population sharded over ranks, and islands.

The counterpart of `repro.core.dist`, with the same names. The JAX package
runs each shard's body under `shard_map` in one process; here each shard
is a rank of a `torch.distributed` group (`launch.mesh`), running the same
body on its own slab. `all_gather(..., tiled=True)` is `all_gather_cat`,
`psum` is `all_reduce_sum`, `axis_index` is the rank's index along the
mesh axis, and `ppermute` around the ring is a gather from which each rank
takes its predecessor's block. On a group whose transport is gloo (ranks
sharing a card, `launch.mesh.collective_backend`) a CUDA tensor goes
through a host copy for the collective; NCCL takes it on the card.

1. `sharded_fitness`: each rank evaluates its P/S-row slab of the
   population, and the gather reassembles the (P, M) objectives.

2. `make_sharded_chunk` / `make_sharded_batched_chunk`: ONE population
   with its axis split over the ``pop`` mesh axis (the layout of
   `sharding.search`). Every rank seeds the same generator and draws the
   whole population's `nsga2.StepDraws`, as JAX replicates the key, so
   selection and variation are replicated bookkeeping. Fitness runs on
   each rank's child slab (the fitness kernel, P/S rows). The domination
   relation is hierarchical (`_hierarchical_ranks`): each rank computes
   only its (2P/S, 2P) row block of the pool with `domination_block`, the
   bool slab kernel, and the front peel merges the per-rank dominator
   counts with one `all_reduce` of (2P,) int32 a front. Integer sums
   partition exactly over ranks, and crowding and truncation run on the
   gathered pool with the single-device arithmetic (never on partial sums
   merged by a reduction, which would reassociate the float32 adds), so a
   sharded chunk equals `nsga2.make_chunk` from the same seed, array for
   array, generator state included. The generations run one by one: a
   CUDA graph cannot capture a gloo collective, so unlike the single-card
   chunk (`nsga2._GraphChunk`) a sharded chunk is not a captured graph.

3. Islands (`make_island_chunk`, `run_islands`): one NSGA-II island a
   rank of the ``data`` ring. Island i draws from its own generator,
   `nsga2.stream_generator(seed, i)`: seeded from
   ``numpy.random.SeedSequence([seed, i])``, as the sweep seeds its
   problem i. Each island runs ``migrate_every`` generations alone (an
   `nsga2.make_chunk`, a captured graph on the card), then `_migrate`
   sends its ``n_migrate`` best around the ring, where they replace the
   receiver's worst. `run_islands_serial` is the same campaign in one
   process, the oracle the ring is held to.

The transport is `core.comm`'s (re-exported here): `COLLECTIVES` counts
the collectives this process issued, by kind.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core import nsga2
from repro_torch.core.comm import (  # noqa: F401  (re-exported)
    COLLECTIVES, all_gather_cat, all_reduce_sum, reset_collectives,
)
from repro_torch.kernels import domination as _dom
from repro_torch.sharding import search as _specs


def assert_replicated(t: torch.Tensor, group, what: str) -> None:
    """Raise unless every rank of ``group`` holds the same ``t``."""
    n = dist.get_world_size(group)
    if n == 1:
        return
    every = all_gather_cat(t.reshape(1, -1), group)
    if not bool((every == every[:1]).all()):
        raise RuntimeError(f"{what} differs between the ranks of the mesh")


def _axis(mesh, axis: str):
    """(group, index along the axis, extent) of ``axis``."""
    return (mesh.get_group(axis), mesh.get_local_rank(axis),
            _specs.axis_extent(mesh, axis))


def gather(t, spec: tuple, mesh):
    """The whole tensor (or list) from this rank's block under ``spec``:
    the inverse of `sharding.search.split`."""
    for dim in reversed(range(len(spec))):
        axis = spec[dim]
        if axis is None:
            continue
        t = all_gather_cat(t, mesh.get_group(axis), dim)
    return t


def gather_state(state: nsga2.NSGA2State, mesh,
                 specs: dict) -> nsga2.NSGA2State:
    """The whole state from every rank's slab (each rank gets it)."""
    return nsga2.NSGA2State(
        *(gather(getattr(state, f), specs[f], mesh)
          for f in _specs.POP_FIELDS), state.generation)


def sharded_fitness(fitness_fn, mesh, axis: str = "pop"):
    """Wrap a (..., P, G) -> (..., P, M) fitness so each rank evaluates
    only its P/S-row slab of the (replicated) population; the gather
    reassembles the monolithic objectives, row for row."""
    group, idx, n = _axis(mesh, axis)

    def eval_sharded(genes: torch.Tensor) -> torch.Tensor:
        p = genes.shape[-2]
        _check_divisible(p, n, axis, "population")
        local = genes.narrow(-2, idx * (p // n), p // n).contiguous()
        return all_gather_cat(fitness_fn(local), group, -2)

    return eval_sharded


# ---------------------------------------------------------------------------
# mesh-sharded global NSGA-II
# ---------------------------------------------------------------------------

def _domination_rows(objs_local: torch.Tensor,
                     objs_full: torch.Tensor) -> torch.Tensor:
    """(..., R_local, R) bool: `domination_block` of each pool's row slab
    against the whole pool (one launch a pool on the card)."""
    if objs_local.dim() == 2:
        return _dom.domination_block(objs_local, objs_full)
    return torch.stack([_dom.domination_block(a, b)
                        for a, b in zip(objs_local, objs_full)])


def _hierarchical_ranks(objs_local: torch.Tensor, objs_full: torch.Tensor,
                        group, start: int) -> torch.Tensor:
    """Global NSGA-II ranks (..., R) from this rank's row block.

    ``objs_local`` (..., R_local, M) is rows [start, start + R_local) of
    ``objs_full`` (..., R, M). The rank computes only its rows of the
    domination relation, and the front peel of `nsga2.non_dominated_sort`
    merges the per-rank dominator counts with an `all_reduce`: one of the
    counts, then one of the (..., R) int32 decrements a front. The loop's
    condition reads only the reduced counts, never rank-local data, so
    every rank peels the same number of fronts, and the (replicated)
    result equals the monolithic sort's."""
    r_local = objs_local.shape[-2]
    dom_rows = _domination_rows(objs_local, objs_full)
    counts = all_reduce_sum(dom_rows.sum(-2, dtype=torch.int32), group)
    rank = torch.full_like(counts, -1)
    r = 0
    while bool((rank < 0).any()):
        current = (counts == 0) & (rank < 0)
        rank = torch.where(current, r, rank)
        cur_rows = current.narrow(-1, start, r_local)
        # removing `current` decrements the dominator count of their dominatees
        part = (dom_rows & cur_rows[..., :, None]).sum(-2, dtype=torch.int32)
        counts = torch.where(rank < 0, counts - all_reduce_sum(part, group),
                             -1)
        r += 1
    return rank


def sharded_non_dominated_sort(objs_local: torch.Tensor, mesh,
                               axis: str = "pop") -> torch.Tensor:
    """`nsga2.non_dominated_sort` of a pool split over ``axis``: this
    rank's (P/S, M) slab in, its (P/S,) slab of the global ranks out,
    equal to the monolithic sort's."""
    group, idx, _ = _axis(mesh, axis)
    full = all_gather_cat(objs_local, group, -2)
    r_local = objs_local.shape[-2]
    ranks = _hierarchical_ranks(objs_local, full, group, idx * r_local)
    return ranks.narrow(-1, idx * r_local, r_local)


def sharded_crowding_distance(objs_local: torch.Tensor,
                              rank_local: torch.Tensor, mesh,
                              axis: str = "pop") -> torch.Tensor:
    """`nsga2.crowding_distance` over a split population.

    Crowding is global, and its float32 per-objective terms are added in
    axis order; merging per-rank partial sums would reassociate those adds.
    So each rank gathers the (P, M) objectives and ranks and runs the
    single-device arithmetic, returning its slab of the same result."""
    group, idx, _ = _axis(mesh, axis)
    full = all_gather_cat(objs_local, group, -2)
    rank_full = all_gather_cat(rank_local, group, -1)
    r_local = objs_local.shape[-2]
    return nsga2.crowding_distance(full, rank_full).narrow(
        -1, idx * r_local, r_local)


def _sharded_gen_body(state: nsga2.NSGA2State, draws: nsga2.StepDraws,
                      fitness_fn, cfg: nsga2.NSGA2Config, group,
                      idx: int) -> nsga2.NSGA2State:
    """One (mu+lambda) generation on a population split over a mesh axis
    (``group``, this rank's index ``idx`` along it).

    ``state`` holds this rank's slab ((K,) P/S rows); ``draws`` are the
    whole population's, the same on every rank. Selection and variation
    run replicated on the gathered population; each rank evaluates its
    contiguous child slab and sorts its (2P/S, 2P) block of the pool
    (`_hierarchical_ranks`); crowding and truncation run on the gathered
    pool with the single-device arithmetic. Equal to `nsga2.make_step` on
    the gathered state."""
    p_local = state.genes.shape[-2]
    full = nsga2.NSGA2State(
        all_gather_cat(state.genes, group, -2),
        all_gather_cat(state.objs, group, -2),
        all_gather_cat(state.rank, group, -1),
        all_gather_cat(state.crowd, group, -1), state.generation)
    p = full.genes.shape[-2]
    children = nsga2.offspring(full, draws, cfg)
    c_local = children.narrow(-2, idx * p_local, p_local).contiguous()
    c_objs = all_gather_cat(fitness_fn(c_local), group, -2)

    pool_genes = torch.cat([full.genes, children], dim=-2)      # (2P, G)
    pool_objs = torch.cat([full.objs, c_objs], dim=-2)          # (2P, M)
    rows = 2 * p_local
    pool_local = pool_objs.narrow(-2, idx * rows, rows).contiguous()
    pool_rank = _hierarchical_ranks(pool_local, pool_objs, group, idx * rows)
    rank, crowd, keep = nsga2.survivors(pool_objs, p, rank=pool_rank)
    mine = keep.narrow(-1, idx * p_local, p_local)
    return nsga2.NSGA2State(nsga2._rows(pool_genes, mine),
                            nsga2._rows(pool_objs, mine),
                            torch.gather(rank, -1, mine),
                            torch.gather(crowd, -1, mine),
                            state.generation + 1)


def _check_divisible(p: int, n: int, axis: str, what: str) -> None:
    if p % n:
        raise ValueError(
            f"{what} size {p} not divisible by mesh axis {axis!r} ({n})")


def make_sharded_step(fitness_fn, mesh, cfg: nsga2.NSGA2Config,
                      axis: str = "pop"):
    """One sharded generation: ``step(state, draws) -> state`` on this
    rank's slab with the whole population's draws (`_sharded_gen_body`)."""
    group, idx, _ = _axis(mesh, axis)

    def step(state: nsga2.NSGA2State,
             draws: nsga2.StepDraws) -> nsga2.NSGA2State:
        return _sharded_gen_body(state, draws, fitness_fn, cfg, group, idx)

    return step


def make_sharded_chunk(fitness_fn, mesh, cfg: nsga2.NSGA2Config,
                       chunk_len: int, axis: str = "pop"):
    """`nsga2.make_chunk` with the population split over ``axis``:
    ``chunk(state, generator) -> state`` on this rank's slab, every
    generation fed by `nsga2.draw_step` over the whole population from the
    replicated ``generator`` (a list of generators for a batched state).
    Equal to the single-device chunk on the gathered state."""
    if chunk_len < 1:
        raise ValueError(f"chunk_len must be >= 1, got {chunk_len}")
    step = make_sharded_step(fitness_fn, mesh, cfg, axis)
    n = _specs.axis_extent(mesh, axis)

    def chunk(state: nsga2.NSGA2State, generator) -> nsga2.NSGA2State:
        p_local, g = state.genes.shape[-2:]
        for _ in range(chunk_len):
            draws = nsga2.draw_step(generator, p_local * n, g,
                                    state.genes.device)
            state = step(state, draws)
        return state

    return chunk


def make_sharded_batched_chunk(fitness_from_ctx, mesh,
                               cfg: nsga2.NSGA2Config, chunk_len: int,
                               bucket_axis: str = "bucket",
                               axis: str = "pop"):
    """`nsga2.make_batched_chunk` spread over a 2-D (bucket, pop) mesh:
    ``chunk(states, ctxs, generators) -> states``. The sweep's stacked
    problems split over ``bucket_axis`` (this rank holds its block of them
    and of their generators, ``ctxs`` their stacked operands) and each
    problem's population over ``axis``; the body is `_sharded_gen_body`
    on the block, each lane equal to its `nsga2.make_chunk` serial oracle.
    The stacked problem count must divide the bucket axis (the sweep pads
    the stack by repeating a problem and drops the extra lanes)."""
    if chunk_len < 1:
        raise ValueError(f"chunk_len must be >= 1, got {chunk_len}")
    del bucket_axis   # no collective runs along it: each block is apart

    def chunk(states: nsga2.NSGA2State, ctxs, generators):
        return make_sharded_chunk(lambda pop: fitness_from_ctx(ctxs, pop),
                                  mesh, cfg, chunk_len, axis)(states,
                                                              generators)

    return chunk


def sharded_state_sharding(mesh, axis: str = "pop") -> dict:
    """Layout of a mesh-sharded global state (`sharding.search`):
    population tensors split over ``axis``; generator and generation
    replicated. Also what a checkpoint restore lays a saved single-device
    state out with (`sharding.search.shard_state`)."""
    del mesh
    return _specs.search_state_specs(axis)


def init_sharded(generator: torch.Generator, fitness_fn, n_genes: int,
                 mesh, cfg: nsga2.NSGA2Config, axis: str = "pop",
                 seed_genes=None) -> nsga2.NSGA2State:
    """`nsga2.init_state` laid out over ``axis``: every rank draws the
    whole initial population from the replicated ``generator``, evaluates
    its slab (`sharded_fitness`), sorts the gathered population and keeps
    its slab, equal to the single-device initial state."""
    _check_divisible(cfg.pop_size, _specs.axis_extent(mesh, axis), axis,
                     "population")
    draws = nsga2.draw_init(generator, cfg.pop_size, n_genes,
                            nsga2.seed_count(seed_genes), generator.device)
    state = nsga2.init_state(sharded_fitness(fitness_fn, mesh, axis), cfg,
                             draws, seed_genes=seed_genes)
    return _specs.shard_state(state, mesh, sharded_state_sharding(mesh, axis))


# ---------------------------------------------------------------------------
# Island model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IslandConfig:
    local_pop: int = 32          # per-island population
    migrate_every: int = 5       # generations between migrations
    n_migrate: int = 4           # elites sent around the ring
    nsga: nsga2.NSGA2Config = dataclasses.field(
        default_factory=nsga2.NSGA2Config)


def island_generator(seed: int, island: int, device) -> torch.Generator:
    """Island ``island``'s generator: `nsga2.stream_generator(seed,
    island)`, seeded from ``numpy.random.SeedSequence([seed, island])``."""
    return nsga2.stream_generator(seed, island, device)


def _elite_order(state: nsga2.NSGA2State) -> torch.Tensor:
    """Indices best first: rank ascending, crowding descending (float32
    keys as JAX's, a stable sort)."""
    key = (state.rank.to(torch.float32) * 1e9
           - torch.clamp_max(state.crowd, 5e8))
    return torch.argsort(key, stable=True)


def _replace_worst(state: nsga2.NSGA2State, worst: torch.Tensor,
                   genes: torch.Tensor, objs: torch.Tensor):
    """``state`` with rows ``worst`` replaced and its ranks and crowding
    recomputed (the single-device sort)."""
    g, o = state.genes.clone(), state.objs.clone()
    g[worst] = genes
    o[worst] = objs
    rank = nsga2.non_dominated_sort(o)
    return nsga2.NSGA2State(g, o, rank, nsga2.crowding_distance(o, rank),
                            state.generation)


def _migrate(state: nsga2.NSGA2State, group, n_migrate: int,
             n_islands: int) -> nsga2.NSGA2State:
    """Ring migration: island i's ``n_migrate`` best replace island
    i + 1's worst (JAX's ``ppermute`` ring, here a gather of every
    island's elites from which each takes its predecessor's)."""
    order = _elite_order(state)
    best, worst = order[:n_migrate], order[-n_migrate:]
    src = (dist.get_rank(group) - 1) % n_islands
    genes = all_gather_cat(state.genes[best], group)
    objs = all_gather_cat(state.objs[best], group)
    return _replace_worst(state, worst,
                          genes[src * n_migrate:(src + 1) * n_migrate],
                          objs[src * n_migrate:(src + 1) * n_migrate])


def make_island_chunk(fitness_fn, mesh, cfg: IslandConfig, n_rounds: int,
                      axis: str = "data"):
    """``n_rounds`` migration rounds: ``chunk(state, generator) -> state``
    on this rank's island. A round is ``migrate_every`` generations of
    `nsga2.make_chunk` (one captured graph on the card, made once) and a
    `_migrate`."""
    if n_rounds < 1:
        raise ValueError(f"n_rounds must be >= 1, got {n_rounds}")
    group, _, n_islands = _axis(mesh, axis)
    evolve = nsga2.make_chunk(fitness_fn, cfg.nsga, cfg.migrate_every)

    def chunk(state: nsga2.NSGA2State, generator) -> nsga2.NSGA2State:
        for _ in range(n_rounds):
            state = _migrate(evolve(state, generator), group, cfg.n_migrate,
                             n_islands)
        return state

    return chunk


def make_island_step(fitness_fn, mesh, cfg: IslandConfig,
                     axis: str = "data"):
    """One migration round (`make_island_chunk` of one round)."""
    return make_island_chunk(fitness_fn, mesh, cfg, 1, axis)


def _init_island(seed: int, island: int, fitness_fn, n_genes: int,
                 cfg: IslandConfig, seed_genes, device):
    local_cfg = dataclasses.replace(cfg.nsga, pop_size=cfg.local_pop)
    gen = island_generator(seed, island, device)
    draws = nsga2.draw_init(gen, cfg.local_pop, n_genes,
                            nsga2.seed_count(seed_genes), device)
    return nsga2.init_state(fitness_fn, local_cfg, draws,
                            seed_genes=seed_genes), gen


def init_islands(seed: int, fitness_fn, n_genes: int, mesh,
                 cfg: IslandConfig, axis: str = "data", seed_genes=None,
                 device="cuda"):
    """(state, generator) of this rank's island: island i is rank i of the
    ring, drawn from `island_generator(seed, i)`; ``seed_genes`` (known
    good designs) go into every island's initial population."""
    return _init_island(seed, mesh.get_local_rank(axis), fitness_fn,
                        n_genes, cfg, seed_genes, device)


def island_state_sharding(mesh, axis: str = "data") -> dict:
    """Layout of the gathered islands state (checkpoint restore): island
    i's rows and generator on rank i."""
    del mesh
    return _specs.island_state_specs(axis)


def run_islands(seed: int, fitness_fn, n_genes: int, mesh,
                cfg: IslandConfig, n_rounds: int, axis: str = "data",
                state=None, generator=None, seed_genes=None, device="cuda"):
    """``n_rounds`` rounds from a fresh start (or from ``state`` and
    ``generator``): (state, generator) of this rank's island."""
    if state is None:
        state, generator = init_islands(seed, fitness_fn, n_genes, mesh, cfg,
                                        axis, seed_genes, device)
    if n_rounds > 0:
        state = make_island_chunk(fitness_fn, mesh, cfg, n_rounds,
                                  axis)(state, generator)
    return state, generator


def run_islands_serial(seed: int, fitness_fn, n_genes: int, n_islands: int,
                       cfg: IslandConfig, n_rounds: int, seed_genes=None,
                       device="cuda") -> list:
    """The islands campaign in one process, the oracle of the ring: every
    island from its own generator, its rounds one after another, the
    migration passed around a Python list. Returns the islands' states in
    ring order."""
    islands = [_init_island(seed, i, fitness_fn, n_genes, cfg, seed_genes,
                            device) for i in range(n_islands)]
    evolve = nsga2.make_chunk(fitness_fn, cfg.nsga, cfg.migrate_every)
    states = [s for s, _ in islands]
    n = cfg.n_migrate
    for _ in range(n_rounds):
        states = [evolve(s, g) for s, (_, g) in zip(states, islands)]
        orders = [_elite_order(s) for s in states]
        states = [_replace_worst(s, orders[i][-n:],
                                 states[i - 1].genes[orders[i - 1][:n]],
                                 states[i - 1].objs[orders[i - 1][:n]])
                  for i, s in enumerate(states)]
    return states


def gathered_pareto(state: nsga2.NSGA2State, mesh, axis: str = "data"):
    """The global pareto front across all islands (every rank gets it)."""
    group = mesh.get_group(axis)
    return nsga2.pareto_front(all_gather_cat(state.objs, group),
                              all_gather_cat(state.genes, group))
