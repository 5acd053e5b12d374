"""Traffic of kind "search": the NSGA-II search of one configuration, the
loop `repro_torch.search.engine` runs without checkpoints.

Set-up has the configuration's family build the port's problem of the
benchmark's inputs (a tree through `build_tree_problem`, master codes
through `problem_from_masters`), builds the family's kernel fitness,
draws and scores the initial population (the exact design seeded in, as
the CLI does) and makes the first chunk call, which captures the chunk's
CUDA graph. The window then calls ``chunk(state, generator)`` back to
back, closed loop, with no sync, one search state carried through, until
the host clock passes ``--seconds``, and synchronises once; the host
clock around each call gives the engine's host time a chunk. The traced
stretch follows the window.

The check judges the window's last chunk. The plain reference (the
family's objectives; it only follows the program's state, so the start
is checked on its own) scores the chunk's starting population and the
final one from their genes, sorts both, and runs the chunk's generations
itself from the starting state with the same draws; every number is
compared exactly.
"""
from __future__ import annotations

import math
import statistics
import time

from perfbench import tracing
from perfbench.reference import search as ref

TRACE_DEVICE_S = 0.25    # the traced chunks last about this long at least
TRACE_CHUNKS = (2, 10)   # and are this many, at least and at most


def _host(state) -> dict:
    return {"genes": state.genes.cpu(), "objs": state.objs.cpu(),
            "rank": state.rank.cpu(), "crowd": state.crowd.cpu()}


def _traced(chunk, state, gen, per_chunk_s: float, length: int) -> dict:
    """Chunks back to back under the profiler, the window opening after
    the first, as in the loop."""
    n = min(max(math.ceil(TRACE_DEVICE_S / per_chunk_s), TRACE_CHUNKS[0]),
            TRACE_CHUNKS[1])
    box = [state]

    def step():
        box[0] = chunk(box[0], gen)

    def stretch():
        for _ in range(n):
            step()

    # the window holds the primed chunk's replay and the n chunks after it
    return {"traced_generations": (n + 1) * length,
            "trace": tracing.profile(stretch, prime=step)}


def measure(ctx):
    import torch

    from repro_torch import families
    from repro_torch.core import nsga2

    pop = int(ctx.traffic["pop_size"])
    length = int(ctx.traffic["chunk_generations"])
    problem, shape = ctx.family.problem(ctx)
    shape.update(genes=int(problem.n_genes))
    fitness = families.family_of(problem).make_fitness(problem, "kernel")
    cfg = nsga2.NSGA2Config(pop_size=pop)
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(ctx.seed)
    seed_genes = problem.exact_genes() if ctx.traffic["seed_exact"] else None
    draws = nsga2.draw_init(gen, pop, problem.n_genes,
                            nsga2.seed_count(seed_genes), ctx.device)
    state = nsga2.init_state(fitness, cfg, draws, seed_genes=seed_genes)
    chunk = nsga2.make_chunk(fitness, cfg, length)
    state = chunk(state, gen)          # the first call captures the graph
    ctx.sync()
    setup_s = time.time() - ctx.t_start

    host_s = []
    t0 = time.perf_counter()
    while True:
        start, gen_state = state, gen.get_state()
        t = time.perf_counter()
        state = chunk(state, gen)
        now = time.perf_counter()
        host_s.append(now - t)
        if now - t0 >= ctx.seconds:
            break
    ctx.sync()
    window_s = time.perf_counter() - t0
    calls = len(host_s)
    judged = {"start": _host(start), "final": _host(state),
              "gen_state": gen_state}

    record = {"kind": "search", "setup_s": setup_s, "window_s": window_s,
              "evals": calls * length * pop, "attempted": calls * length * pop,
              "failed": 0, "shape": shape, "trace": None,
              "chunk_host_ms": statistics.median(host_s) * 1e3}
    if ctx.trace:
        record.update(_traced(chunk, state, gen, window_s / calls, length))
    del problem, fitness, draws, chunk, state, start

    def judge():
        objectives = ctx.family.objectives(ctx)
        dev = ctx.device
        gaps, mismatched = [], 0
        for s in (judged["start"], judged["final"]):
            objs = s["objs"].to(dev)
            gaps.append(float((objectives(s["genes"].to(dev)) - objs)
                              .abs().max()))
            mismatched += int((ref.fronts(objs).cpu() != s["rank"]).sum())
        followed = ref.follow(judged["start"], judged["gen_state"], length,
                              objectives, dev)
        follow_gap = max(float((followed[k].cpu().double()
                                - judged["final"][k].double()).abs().max())
                         for k in ("genes", "objs", "rank", "crowd"))
        return [("fitness_gap", max(gaps), 0.0),
                ("rank_mismatch", float(mismatched), 0.0),
                ("follow_gap", follow_gap, 0.0)]

    return record, judge
