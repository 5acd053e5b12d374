"""NSGA-II (Deb et al. 2002) on torch tensors, the design-space explorer.

The counterpart of `repro.core.nsga2`: elitist (mu+lambda), binary
tournament on (rank, crowding), simulated binary crossover, polynomial
mutation, fast non-dominated sort, crowding-distance truncation. Two
differences from the JAX package:

- Random draws are explicit tensors (`InitDraws`, `StepDraws`), made from a
  `torch.Generator` by `draw_init` / `draw_step`. torch cannot replay
  `jax.random` streams, so the operators take their draws as arguments and
  the tests feed them the reference's draws.
- `non_dominated_sort` on a CUDA pool, of any size, is the card's sort
  (`kernels.domination.non_dominated_rank`): the domination relation as
  bits and one launch that peels every front, with no host sync, as the
  reference peels in a `jax.lax.while_loop` whatever the pool. On the CPU it
  is that sort's plain version, a Python loop over the bool matrix that
  asks once per front whether any individual is still unranked.

Sorts are stable (`jnp.argsort` is), and crowding adds its per-objective
terms in axis order, so ranks, crowding and survivors equal the reference.
`make_chunk` runs several generations per call, as one CUDA graph on the
card, equal to the per-generation loop.

A leading problem axis (the sweep's bucket of K problems, the counterpart
of the JAX package's `vmap` of the GA): every operator takes states of
(K, P, ...) as well as (P, ...), gathering along the population axis of
each problem, and the sort and the fitness kernel take the K pools in one
launch each. Each problem draws from its own generator into its slice of
the draws (`draw_step` with a list of generators), so a problem's numbers
are the ones it draws alone, and a batched run equals the problems run one
by one. `pow` is rounded once from float64 (`_pow`): the CPU's vectorised
float32 `pow` and its scalar tail differ in the last bit, which would make
a float32 result depend on where an element falls in its tensor.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.domination import domination_block
from repro_torch.runtime import graphs, trace

_BIG = 1e9


def non_dominated_sort(objs: torch.Tensor) -> torch.Tensor:
    """int32 rank per individual (0 = first/pareto front); objs (P, M), or
    (K, P, M) for K pools."""
    return kops.non_dominated_rank(objs)


def domination_matrix(objs: torch.Tensor,
                      against: torch.Tensor | None = None) -> torch.Tensor:
    """objs (Pi, M), minimised: out[i, j] is True iff objs[i] dominates
    against[j] (default ``against = objs``), `domination_block` (the
    kernel on a CUDA tensor)."""
    return domination_block(objs, objs if against is None else against)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (..., R) of x (..., P, D), per problem: (..., R, D)."""
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def crowding_distance(objs: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Crowding distance per individual, computed within each front; objs
    (..., P, M), rank (..., P).

    Per objective: a stable sort on (rank * 1e9 + value), neighbours within
    the same front, per-front min/max normalisation, +1e9 at the front's
    ends. The per-objective terms are added in axis order, as the
    reference does, so float32 rounding matches it.
    """
    *lead, p, m = objs.shape
    rank_l = rank.long()
    dev = objs.device
    dist = None
    for k in range(m):
        v = objs[..., k]
        key = rank.to(torch.float32) * _BIG + v
        order = torch.argsort(key, dim=-1, stable=True)
        v_s = torch.gather(v, -1, order)
        r_s = torch.gather(rank_l, -1, order)
        same = r_s[..., 1:] == r_s[..., :-1]
        false = torch.zeros((*lead, 1), dtype=torch.bool, device=dev)
        prev_ok = torch.cat([false, same], -1)
        next_ok = torch.cat([same, false], -1)
        v_prev = torch.cat([v_s[..., :1], v_s[..., :-1]], -1)
        v_next = torch.cat([v_s[..., 1:], v_s[..., -1:]], -1)
        fmin = torch.full((*lead, p), float("inf"), device=dev).scatter_reduce(
            -1, r_s, v_s, "amin")
        fmax = torch.full((*lead, p), float("-inf"), device=dev).scatter_reduce(
            -1, r_s, v_s, "amax")
        span = torch.clamp_min(torch.gather(fmax - fmin, -1, r_s), 1e-12)
        d = torch.where(prev_ok & next_ok, (v_next - v_prev) / span,
                        float("inf"))
        contrib = torch.zeros((*lead, p), dtype=torch.float32,
                              device=dev).scatter(
            -1, order, torch.where(torch.isinf(d), _BIG, d))
        dist = contrib if dist is None else dist + contrib
    return dist


def _tournament(rank, crowd, a, b):
    """Binary tournament over drawn index pairs (a, b): lower rank wins;
    tie -> higher crowding wins; tie -> a."""
    ra, rb = torch.gather(rank, -1, a), torch.gather(rank, -1, b)
    ca, cb = torch.gather(crowd, -1, a), torch.gather(crowd, -1, b)
    a_wins = (ra < rb) | ((ra == rb) & (ca >= cb))
    return torch.where(a_wins, a, b)


def _pow(base: torch.Tensor, exponent: float) -> torch.Tensor:
    """float32 ``base ** exponent``, computed in float64 and rounded once
    (the same value wherever the element lies in its tensor)."""
    return (base.to(torch.float64) ** exponent).to(torch.float32)


def _sbx(parents_a, parents_b, u, do_u, swap_u, eta_c, p_cross):
    """Simulated binary crossover on [0,1] genes with drawn uniforms."""
    e = 1.0 / (eta_c + 1.0)
    beta = torch.where(u <= 0.5, _pow(2.0 * u, e),
                       _pow(1.0 / (2.0 * (1.0 - u)), e))
    c1 = 0.5 * ((1 + beta) * parents_a + (1 - beta) * parents_b)
    c2 = 0.5 * ((1 - beta) * parents_a + (1 + beta) * parents_b)
    do = (do_u < p_cross)[..., None]
    c1 = torch.where(do, c1, parents_a)
    c2 = torch.where(do, c2, parents_b)
    swap = swap_u < 0.5
    o1 = torch.where(swap, c1, c2)
    o2 = torch.where(swap, c2, c1)
    return torch.clamp(o1, 0.0, 1.0), torch.clamp(o2, 0.0, 1.0)


def _poly_mutation(genes, u, mask_u, eta_m, p_mut):
    e = 1.0 / (eta_m + 1.0)
    delta = torch.where(u < 0.5, _pow(2.0 * u, e) - 1.0,
                        1.0 - _pow(2.0 * (1.0 - u), e))
    mask = mask_u < p_mut
    return torch.clamp(genes + torch.where(mask, delta, 0.0), 0.0, 1.0)


@dataclasses.dataclass
class NSGA2Config:
    pop_size: int = 64
    n_generations: int = 40
    eta_crossover: float = 20.0
    eta_mutation: float = 20.0
    p_crossover: float = 0.9
    p_mutation: float | None = None  # default 1/n_genes


@dataclasses.dataclass
class NSGA2State:
    """One population, or K of them on a leading problem axis."""

    genes: torch.Tensor   # ([K,] P, G) float32
    objs: torch.Tensor    # ([K,] P, M) float32
    rank: torch.Tensor    # ([K,] P) int32
    crowd: torch.Tensor   # ([K,] P) float32
    generation: int

    def member(self, i: int) -> "NSGA2State":
        """Problem ``i`` of a batched state."""
        return NSGA2State(self.genes[i], self.objs[i], self.rank[i],
                          self.crowd[i], self.generation)


@dataclasses.dataclass
class InitDraws:
    """Random numbers of `init_state` (a leading K axis when batched)."""

    genes: torch.Tensor   # ([K,] P, G) uniform [0, 1)
    jitter: torch.Tensor  # ([K,] n_seed, G) standard normal


@dataclasses.dataclass
class StepDraws:
    """Random numbers of one `make_step` generation (a leading K axis when
    batched)."""

    tour_a: torch.Tensor    # ([K,] P) int64 in [0, P)
    tour_b: torch.Tensor    # ([K,] P) int64 in [0, P)
    sbx_u: torch.Tensor     # ([K,] P/2, G) uniform
    sbx_do: torch.Tensor    # ([K,] P/2) uniform, crossover where < p_crossover
    sbx_swap: torch.Tensor  # ([K,] P/2, G) uniform, swap where < 0.5
    mut_u: torch.Tensor     # ([K,] P, G) uniform
    mut_mask: torch.Tensor  # ([K,] P, G) uniform, mutate where < p_mutation

    def member(self, i: int) -> "StepDraws":
        """Problem ``i``'s draws of batched draws (views)."""
        return StepDraws(**{f.name: getattr(self, f.name)[i]
                            for f in dataclasses.fields(StepDraws)})


def _batched(generator) -> bool:
    """True for a sequence of generators, one per problem of a batch."""
    return isinstance(generator, (list, tuple))


def n_seeded(pop_size: int, n_seed_genes: int) -> int:
    """Initial individuals filled with (jittered) seed chromosomes."""
    return min(pop_size // 2, max(n_seed_genes, pop_size // 8))


def seed_count(seed_genes) -> int:
    """Rows of ``seed_genes`` (one chromosome or (S, G)); 0 for None."""
    return 0 if seed_genes is None else np.atleast_2d(
        np.asarray(seed_genes)).shape[0]


def stream_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of stream ``index`` under ``seed`` on ``device``,
    seeded from ``numpy.random.SeedSequence([seed, index])``: the sweep's
    problem i and the islands' island i (the counterpart of JAX's
    ``fold_in`` and ``split``), so a stream never depends on the others."""
    state = np.random.SeedSequence([seed, index]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) | (int(state[1]) << 31))
    return gen


def draw_init(generator, pop_size: int, n_genes: int, n_seed_genes: int,
              device) -> InitDraws:
    """The initial population's draws from ``generator``; for a list of
    generators, problem i's from generator i, stacked."""
    if _batched(generator):
        draws = [draw_init(g, pop_size, n_genes, n_seed_genes, device)
                 for g in generator]
        return InitDraws(genes=torch.stack([d.genes for d in draws]),
                         jitter=torch.stack([d.jitter for d in draws]))
    n_seed = n_seeded(pop_size, n_seed_genes) if n_seed_genes else 0
    return InitDraws(
        genes=torch.rand((pop_size, n_genes), generator=generator,
                         device=device),
        jitter=torch.randn((n_seed, n_genes), generator=generator,
                           device=device))


def _step_shapes(pop_size: int, n_genes: int) -> dict:
    half = pop_size // 2
    return {"tour_a": (pop_size,), "tour_b": (pop_size,),
            "sbx_u": (half, n_genes), "sbx_do": (half,),
            "sbx_swap": (half, n_genes), "mut_u": (pop_size, n_genes),
            "mut_mask": (pop_size, n_genes)}


def empty_step_draws(lead: tuple, pop_size: int, n_genes: int,
                     device) -> StepDraws:
    """Zeroed draw buffers of shape (*lead, ...) each."""
    return StepDraws(**{
        name: torch.zeros((*lead, *shape), device=device,
                          dtype=torch.int64 if name.startswith("tour")
                          else torch.float32)
        for name, shape in _step_shapes(pop_size, n_genes).items()})


def draw_step(generator, pop_size: int, n_genes: int, device,
              out: StepDraws | None = None) -> StepDraws:
    """One generation's draws, in a fixed order; with ``out`` they are
    drawn into its (contiguous) tensors, the same numbers. For a list of
    generators, problem i draws from generator i into row i of batched
    draws, the numbers it draws alone."""
    if _batched(generator):
        if out is None:
            out = empty_step_draws((len(generator),), pop_size, n_genes,
                                   device)
        for i, g in enumerate(generator):
            draw_step(g, pop_size, n_genes, device, out=out.member(i))
        return out
    shapes = _step_shapes(pop_size, n_genes)
    trace.count("nsga2.draws", len(shapes))
    drawn = {}
    for name, shape in shapes.items():
        kw = dict(generator=generator, device=device)
        if out is not None:
            kw["out"] = getattr(out, name)
        drawn[name] = (torch.randint(0, pop_size, shape, **kw)
                       if name.startswith("tour") else torch.rand(shape, **kw))
    return StepDraws(**drawn)


def init_state(fitness_fn, cfg: NSGA2Config, draws: InitDraws,
               seed_genes=None) -> NSGA2State:
    """seed_genes (S, G): known-good designs (e.g. the exact bespoke design)
    injected into the initial population, the first S pristine and the rest
    jittered copies; batched draws give every problem the same seeds."""
    genes = draws.genes.clone()
    if seed_genes is not None:
        seeds = torch.as_tensor(np.atleast_2d(np.asarray(seed_genes)),
                                dtype=torch.float32, device=genes.device)
        k = seeds.shape[0]
        n_seed = n_seeded(cfg.pop_size, k)
        reps = seeds.repeat((n_seed + k - 1) // k, 1)[:n_seed]
        jitter = draws.jitter * 0.03
        jitter[..., :k, :] = 0.0  # keep pristine seeds
        genes[..., :n_seed, :] = torch.clamp(reps + jitter, 0.0, 1.0)
    objs = fitness_fn(genes)
    rank = non_dominated_sort(objs)
    crowd = crowding_distance(objs, rank)
    return NSGA2State(genes, objs, rank, crowd, 0)


def survivors(pool_objs: torch.Tensor, pop_size: int,
              rank: torch.Tensor | None = None):
    """(rank, crowd, keep): ranks and crowding of the pool and the indices
    of the ``pop_size`` survivors (rank ascending, crowding descending).
    ``rank``, when given, is the pool's ranks, sorted elsewhere (the
    sharded sort of `core.dist`)."""
    if rank is None:
        rank = non_dominated_sort(pool_objs)
    crowd = crowding_distance(pool_objs, rank)
    key = rank.to(torch.float32) * _BIG - torch.clamp_max(crowd, _BIG / 2)
    keep = torch.argsort(key, dim=-1, stable=True)[..., :pop_size]
    return rank, crowd, keep


def offspring(state: NSGA2State, draws: StepDraws,
              cfg: NSGA2Config) -> torch.Tensor:
    """The generation's children: tournament, crossover and mutation on
    the drawn numbers."""
    p, g = state.genes.shape[-2:]
    if p % 2:
        raise ValueError(f"pop_size must be even, got {p}")
    p_mut = cfg.p_mutation if cfg.p_mutation is not None else 1.0 / g
    idx = _tournament(state.rank, state.crowd, draws.tour_a, draws.tour_b)
    pa = _rows(state.genes, idx[..., 0::2])
    pb = _rows(state.genes, idx[..., 1::2])
    o1, o2 = _sbx(pa, pb, draws.sbx_u, draws.sbx_do, draws.sbx_swap,
                  cfg.eta_crossover, cfg.p_crossover)
    children = torch.cat([o1, o2], dim=-2)[..., :p, :]
    return _poly_mutation(children, draws.mut_u, draws.mut_mask,
                          cfg.eta_mutation, p_mut)


def make_step(fitness_fn, cfg: NSGA2Config):
    """One (mu+lambda) generation: ``step(state, draws) -> state``."""

    def step(state: NSGA2State, draws: StepDraws) -> NSGA2State:
        p = state.genes.shape[-2]
        children = offspring(state, draws, cfg)
        c_objs = fitness_fn(children)

        pool_genes = torch.cat([state.genes, children], dim=-2)
        pool_objs = torch.cat([state.objs, c_objs], dim=-2)
        rank, crowd, keep = survivors(pool_objs, p)
        return NSGA2State(_rows(pool_genes, keep), _rows(pool_objs, keep),
                          torch.gather(rank, -1, keep),
                          torch.gather(crowd, -1, keep),
                          state.generation + 1)

    return step


def make_chunk(fitness_fn, cfg: NSGA2Config, chunk_len: int):
    """``chunk_len`` generations of `make_step` as one call:
    ``chunk(state, generator) -> state``, each generation fed by `draw_step`
    from ``generator``, so a chunked run equals the per-generation loop.

    On the CPU it is that loop. On a CUDA device the chunk is one captured
    CUDA graph, replayed once per call (the JAX package's `lax.scan` over
    the step): the first call runs one eager step on the chunk's own
    buffers, under `torch.cuda.set_sync_debug_mode("error")` (so every
    kernel is built and nothing in the step waits for the host), then
    captures the ``chunk_len`` steps. Each call draws the chunk's numbers
    eagerly, in generation order, into static buffers that generation g of
    the graph reads (each draw counted in ``nsga2.draws``), copies the
    state in and replays. Kernel launch counts and the fitness's
    ``nsga2.evaluations`` advance by the graph's at every replay
    (`runtime.graphs.Graph.replay`); `make_chunk.captures` counts the
    graphs. A call is the span ``nsga2.chunk``; on the card its phases
    are ``nsga2.chunk.draw``, ``.load``, ``.replay`` and ``.unload``
    (`runtime.trace`).

    A batched state (K problems) takes a list of K generators, problem i
    drawing from generator i (`draw_step`); ``fitness_fn`` then maps
    (K, P, G) genes to (K, P, M) objectives."""
    if chunk_len < 1:
        raise ValueError(f"chunk_len must be >= 1, got {chunk_len}")
    step = make_step(fitness_fn, cfg)
    captured = []

    def chunk(state: NSGA2State, generator) -> NSGA2State:
        p, g = state.genes.shape[-2:]
        dev = state.genes.device
        with trace.span("nsga2.chunk"):
            if dev.type != "cuda":
                for _ in range(chunk_len):
                    state = step(state, draw_step(generator, p, g, dev))
                return state
            if not captured:
                captured.append(_GraphChunk(step, chunk_len, state))
            return captured[0].run(state, generator)

    return chunk


make_chunk.captures = 0

_STATE_TENSORS = ("genes", "objs", "rank", "crowd")


class _GraphChunk:
    """A chunk of generations captured as one CUDA graph (`make_chunk`)."""

    def __init__(self, step, chunk_len: int, state: NSGA2State):
        *lead, p, g = state.genes.shape
        dev = state.genes.device
        self.inputs = NSGA2State(*(getattr(state, f).clone()
                                   for f in _STATE_TENSORS), 0)
        draws = empty_step_draws((chunk_len, *lead), p, g, dev)
        self.draws = [draws.member(i) for i in range(chunk_len)]

        def chunk():
            out = self.inputs
            for d in self.draws:
                out = step(out, d)
            return out

        self.graph, self.outputs = graphs.capture(
            lambda: step(self.inputs, self.draws[0]), chunk, dev)
        make_chunk.captures += 1

    def run(self, state: NSGA2State, generator) -> NSGA2State:
        p, g = state.genes.shape[-2:]
        with trace.span("nsga2.chunk.draw"):
            for d in self.draws:
                draw_step(generator, p, g, state.genes.device, out=d)
        with trace.span("nsga2.chunk.load"):
            for f in _STATE_TENSORS:
                getattr(self.inputs, f).copy_(getattr(state, f))
        with trace.span("nsga2.chunk.replay"):
            self.graph.replay()
        with trace.span("nsga2.chunk.unload"):
            return NSGA2State(*(getattr(self.outputs, f).clone()
                                for f in _STATE_TENSORS),
                              state.generation + len(self.draws))


def make_batched_init(fitness_fn, n_genes: int, cfg: NSGA2Config,
                      seed_genes=None):
    """`init_state` over a leading problem axis: ``init(generators, device)
    -> state`` of K problems, problem i drawn from ``generators[i]``, with
    ``fitness_fn`` mapping (K, P, G) genes to (K, P, M). ``seed_genes`` is
    shared (the sweep pads a bucket's members to one chromosome length,
    and the exact design to the same inert encoding). The counterpart of
    the JAX package's vmapped `init_state`: one fitness launch and one
    sort for the whole bucket."""

    def init(generators, device) -> NSGA2State:
        draws = draw_init(list(generators), cfg.pop_size, n_genes,
                          seed_count(seed_genes), device)
        return init_state(fitness_fn, cfg, draws, seed_genes=seed_genes)

    return init


# The JAX package's name for the chunk over a leading problem axis: here it
# is `make_chunk` itself, whose ``chunk(state, generators)`` takes a batched
# state and a list (or tuple) of K generators, problem i drawing from
# generator i, so each problem equals `make_chunk` run on it alone.
make_batched_chunk = make_chunk


def run(generator: torch.Generator, fitness_fn, n_genes: int,
        cfg: NSGA2Config, state: NSGA2State | None = None,
        seed_genes=None) -> NSGA2State:
    """Run the GA for ``cfg.n_generations``; ``state`` continues a run.

    The counterpart of the JAX package's ``run(key, ...)``: the draws come
    from ``generator`` on its device (`draw_init`, then `draw_step` a
    generation), so the same generator state gives the same run. PyTorch
    runs eagerly, so ``fitness_fn`` may be any tensor function, and the
    JAX ``jit`` switch has no counterpart."""
    dev = generator.device
    if state is None:
        draws = draw_init(generator, cfg.pop_size, n_genes,
                          seed_count(seed_genes), dev)
        state = init_state(fitness_fn, cfg, draws, seed_genes)
    step = make_step(fitness_fn, cfg)
    for _ in range(cfg.n_generations):
        state = step(state, draw_step(generator, cfg.pop_size, n_genes, dev))
    return state


def pareto_front(objs: torch.Tensor, genes: torch.Tensor):
    """The non-dominated set as numpy arrays, sorted by the first objective."""
    mask = (non_dominated_sort(objs) == 0).cpu().numpy()
    objs_np = objs.cpu().numpy()[mask]
    genes_np = genes.cpu().numpy()[mask]
    order = np.argsort(objs_np[:, 0])
    return objs_np[order], genes_np[order]
