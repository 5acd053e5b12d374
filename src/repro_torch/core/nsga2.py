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
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.kernels import ops as kops

_BIG = 1e9


def non_dominated_sort(objs: torch.Tensor) -> torch.Tensor:
    """int32 rank per individual (0 = first/pareto front)."""
    return kops.non_dominated_rank(objs)


def crowding_distance(objs: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Crowding distance per individual, computed within each front.

    Per objective: a stable sort on (rank * 1e9 + value), neighbours within
    the same front, per-front min/max normalisation, +1e9 at the front's
    ends. The per-objective terms are added in axis order, as the
    reference does, so float32 rounding matches it.
    """
    p, m = objs.shape
    rank_l = rank.long()
    dist = None
    for k in range(m):
        v = objs[:, k]
        key = rank.to(torch.float32) * _BIG + v
        order = torch.argsort(key, stable=True)
        v_s = v[order]
        r_s = rank_l[order]
        same = r_s[1:] == r_s[:-1]
        false = torch.zeros((1,), dtype=torch.bool, device=objs.device)
        prev_ok = torch.cat([false, same])
        next_ok = torch.cat([same, false])
        v_prev = torch.cat([v_s[:1], v_s[:-1]])
        v_next = torch.cat([v_s[1:], v_s[-1:]])
        fmin = torch.full((p,), float("inf"), device=objs.device).scatter_reduce(
            0, r_s, v_s, "amin")
        fmax = torch.full((p,), float("-inf"), device=objs.device).scatter_reduce(
            0, r_s, v_s, "amax")
        span = torch.clamp_min((fmax - fmin)[r_s], 1e-12)
        d = torch.where(prev_ok & next_ok, (v_next - v_prev) / span,
                        float("inf"))
        contrib = torch.zeros((p,), dtype=torch.float32, device=objs.device)
        contrib[order] = torch.where(torch.isinf(d), _BIG, d)
        dist = contrib if dist is None else dist + contrib
    return dist


def _tournament(rank, crowd, a, b):
    """Binary tournament over drawn index pairs (a, b): lower rank wins;
    tie -> higher crowding wins; tie -> a."""
    a_wins = (rank[a] < rank[b]) | ((rank[a] == rank[b]) & (crowd[a] >= crowd[b]))
    return torch.where(a_wins, a, b)


def _sbx(parents_a, parents_b, u, do_u, swap_u, eta_c, p_cross):
    """Simulated binary crossover on [0,1] genes with drawn uniforms."""
    beta = torch.where(
        u <= 0.5,
        (2.0 * u) ** (1.0 / (eta_c + 1.0)),
        (1.0 / (2.0 * (1.0 - u))) ** (1.0 / (eta_c + 1.0)),
    )
    c1 = 0.5 * ((1 + beta) * parents_a + (1 - beta) * parents_b)
    c2 = 0.5 * ((1 - beta) * parents_a + (1 + beta) * parents_b)
    do = (do_u < p_cross)[:, None]
    c1 = torch.where(do, c1, parents_a)
    c2 = torch.where(do, c2, parents_b)
    swap = swap_u < 0.5
    o1 = torch.where(swap, c1, c2)
    o2 = torch.where(swap, c2, c1)
    return torch.clamp(o1, 0.0, 1.0), torch.clamp(o2, 0.0, 1.0)


def _poly_mutation(genes, u, mask_u, eta_m, p_mut):
    delta = torch.where(
        u < 0.5,
        (2.0 * u) ** (1.0 / (eta_m + 1.0)) - 1.0,
        1.0 - (2.0 * (1.0 - u)) ** (1.0 / (eta_m + 1.0)),
    )
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
    genes: torch.Tensor   # (P, G) float32
    objs: torch.Tensor    # (P, M) float32
    rank: torch.Tensor    # (P,) int32
    crowd: torch.Tensor   # (P,) float32
    generation: int


@dataclasses.dataclass
class InitDraws:
    """Random numbers of `init_state`."""

    genes: torch.Tensor   # (P, G) uniform [0, 1)
    jitter: torch.Tensor  # (n_seed, G) standard normal


@dataclasses.dataclass
class StepDraws:
    """Random numbers of one `make_step` generation."""

    tour_a: torch.Tensor    # (P,) int64 in [0, P)
    tour_b: torch.Tensor    # (P,) int64 in [0, P)
    sbx_u: torch.Tensor     # (P/2, G) uniform
    sbx_do: torch.Tensor    # (P/2,) uniform, crossover where < p_crossover
    sbx_swap: torch.Tensor  # (P/2, G) uniform, swap where < 0.5
    mut_u: torch.Tensor     # (P, G) uniform
    mut_mask: torch.Tensor  # (P, G) uniform, mutate where < p_mutation


def n_seeded(pop_size: int, n_seed_genes: int) -> int:
    """Initial individuals filled with (jittered) seed chromosomes."""
    return min(pop_size // 2, max(n_seed_genes, pop_size // 8))


def draw_init(generator: torch.Generator, pop_size: int, n_genes: int,
              n_seed_genes: int, device) -> InitDraws:
    n_seed = n_seeded(pop_size, n_seed_genes) if n_seed_genes else 0
    return InitDraws(
        genes=torch.rand((pop_size, n_genes), generator=generator,
                         device=device),
        jitter=torch.randn((n_seed, n_genes), generator=generator,
                           device=device))


def draw_step(generator: torch.Generator, pop_size: int, n_genes: int,
              device, out: StepDraws | None = None) -> StepDraws:
    """One generation's draws, in a fixed order; with ``out`` they are
    drawn into its (contiguous) tensors, the same numbers."""
    half = pop_size // 2
    shapes = {"tour_a": (pop_size,), "tour_b": (pop_size,),
              "sbx_u": (half, n_genes), "sbx_do": (half,),
              "sbx_swap": (half, n_genes), "mut_u": (pop_size, n_genes),
              "mut_mask": (pop_size, n_genes)}
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
    """seed_genes (K, G): known-good designs (e.g. the exact bespoke design)
    injected into the initial population, the first K pristine and the rest
    jittered copies."""
    genes = draws.genes.clone()
    if seed_genes is not None:
        seeds = torch.as_tensor(np.atleast_2d(np.asarray(seed_genes)),
                                dtype=torch.float32, device=genes.device)
        k = seeds.shape[0]
        n_seed = n_seeded(cfg.pop_size, k)
        reps = seeds.repeat((n_seed + k - 1) // k, 1)[:n_seed]
        jitter = draws.jitter * 0.03
        jitter[:k] = 0.0  # keep pristine seeds
        genes[:n_seed] = torch.clamp(reps + jitter, 0.0, 1.0)
    objs = fitness_fn(genes)
    rank = non_dominated_sort(objs)
    crowd = crowding_distance(objs, rank)
    return NSGA2State(genes, objs, rank, crowd, 0)


def survivors(pool_objs: torch.Tensor, pop_size: int):
    """(rank, crowd, keep): ranks and crowding of the pool and the indices
    of the ``pop_size`` survivors (rank ascending, crowding descending)."""
    rank = non_dominated_sort(pool_objs)
    crowd = crowding_distance(pool_objs, rank)
    key = rank.to(torch.float32) * _BIG - torch.clamp_max(crowd, _BIG / 2)
    keep = torch.argsort(key, stable=True)[:pop_size]
    return rank, crowd, keep


def make_step(fitness_fn, cfg: NSGA2Config):
    """One (mu+lambda) generation: ``step(state, draws) -> state``."""

    def step(state: NSGA2State, draws: StepDraws) -> NSGA2State:
        p, g = state.genes.shape
        if p % 2:
            raise ValueError(f"pop_size must be even, got {p}")
        p_mut = cfg.p_mutation if cfg.p_mutation is not None else 1.0 / g
        idx = _tournament(state.rank, state.crowd, draws.tour_a, draws.tour_b)
        pa, pb = state.genes[idx[0::2]], state.genes[idx[1::2]]
        o1, o2 = _sbx(pa, pb, draws.sbx_u, draws.sbx_do, draws.sbx_swap,
                      cfg.eta_crossover, cfg.p_crossover)
        children = torch.cat([o1, o2], dim=0)[:p]
        children = _poly_mutation(children, draws.mut_u, draws.mut_mask,
                                  cfg.eta_mutation, p_mut)
        c_objs = fitness_fn(children)

        pool_genes = torch.cat([state.genes, children], dim=0)
        pool_objs = torch.cat([state.objs, c_objs], dim=0)
        rank, crowd, keep = survivors(pool_objs, p)
        return NSGA2State(pool_genes[keep], pool_objs[keep], rank[keep],
                          crowd[keep], state.generation + 1)

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
    the graph reads, copies the state in and replays. Kernel launch counts
    advance by the graph's launches at every replay
    (`kernels.add_launches`); `make_chunk.captures` counts the graphs."""
    if chunk_len < 1:
        raise ValueError(f"chunk_len must be >= 1, got {chunk_len}")
    step = make_step(fitness_fn, cfg)
    captured = []

    def chunk(state: NSGA2State, generator: torch.Generator) -> NSGA2State:
        p, g = state.genes.shape
        dev = state.genes.device
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
        p, g = state.genes.shape
        dev = state.genes.device
        self.inputs = NSGA2State(*(getattr(state, f).clone()
                                   for f in _STATE_TENSORS), 0)
        half = p // 2

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros((chunk_len, *shape), dtype=dtype, device=dev)

        draws = StepDraws(
            tour_a=zeros(p, dtype=torch.int64),
            tour_b=zeros(p, dtype=torch.int64), sbx_u=zeros(half, g),
            sbx_do=zeros(half), sbx_swap=zeros(half, g), mut_u=zeros(p, g),
            mut_mask=zeros(p, g))
        self.draws = [StepDraws(**{f.name: getattr(draws, f.name)[i]
                                   for f in dataclasses.fields(StepDraws)})
                      for i in range(chunk_len)]
        # warm-up on a side stream, as graph capture wants: every kernel is
        # built and its libraries' handles made before the capture
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                step(self.inputs, self.draws[0])
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = kernels.launch_snapshot()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            out = self.inputs
            for d in self.draws:
                out = step(out, d)
        self.outputs = out
        self.launches = kernels.rewind_launches(before)
        make_chunk.captures += 1

    def run(self, state: NSGA2State, generator: torch.Generator) -> NSGA2State:
        p, g = state.genes.shape
        for d in self.draws:
            draw_step(generator, p, g, state.genes.device, out=d)
        for f in _STATE_TENSORS:
            getattr(self.inputs, f).copy_(getattr(state, f))
        self.graph.replay()
        kernels.add_launches(self.launches)
        return NSGA2State(*(getattr(self.outputs, f).clone()
                            for f in _STATE_TENSORS),
                          state.generation + len(self.draws))


def pareto_front(objs: torch.Tensor, genes: torch.Tensor):
    """The non-dominated set as numpy arrays, sorted by the first objective."""
    mask = (non_dominated_sort(objs) == 0).cpu().numpy()
    objs_np = objs.cpu().numpy()[mask]
    genes_np = genes.cpu().numpy()[mask]
    order = np.argsort(objs_np[:, 0])
    return objs_np[order], genes_np[order]
