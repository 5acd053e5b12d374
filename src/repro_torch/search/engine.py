"""`run_search`: the NSGA-II search loop, for any classifier family.

The counterpart of the single-device path of `repro.search.engine`:

    problem = search.build_problem(ptree, x_test, y_test, device="cuda")
    result  = search.run_search(problem, SearchConfig(backend="kernel"))

``problem`` is a family's problem (a tree or forest `SearchProblem` or a
printed-MLP `families.printed_mlp.MLPProblem`): the loop reads only its
``device``, ``n_genes`` and ``exact_genes()``, and hands fitness
construction and the artifact back to the family.

Generations run as `nsga2.make_chunk` chunks of ``checkpoint_every``
generations (the whole run when checkpointing is off or there is no
``out_dir``), each one CUDA graph on the card, with the draws made from a
`torch.Generator` seeded with ``cfg.seed`` on the problem's device; a
chunked run equals the per-generation loop. `SearchResult.n_dispatches`
counts the host calls: the initial population and one per chunk.
``checkpoint_every`` saves the population and the generator's state
through `runtime.checkpoint` under ``out_dir/ckpt`` and ``resume=True``
continues from the newest intact save. With ``out_dir`` the pareto front is
written to ``pareto.json`` (the family's schema) in the format
`repro.search.load_pareto_artifact` reads.

``mesh`` (a `launch.mesh.make_search_mesh` spec) splits the population
over the ranks of a process group: the same chunk schedule runs through
`core.dist.make_sharded_chunk`, generation by generation (a gloo
collective cannot be captured in a CUDA graph), with the same arrays, so
checkpoints stay in the "single" layout and a run saved under one mesh
resumes under another, or none, bit for bit. ``backend="islands"`` runs
one NSGA-II island a rank of a ring (``mesh``, default "auto") with
migrations every ``migrate_every`` generations (`core.dist`); its
generations round up to whole rounds and its checkpoints land on round
boundaries. On a mesh every rank runs `run_search`; rank 0 alone writes
checkpoints and artifacts while the others wait, and every rank returns
the gathered result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch.core import nsga2, quant
from repro_torch.search import backends as _backends
from repro_torch.search.problem import SearchProblem


@dataclasses.dataclass
class SearchConfig:
    backend: str = "reference"      # reference | kernel | islands
    pop_size: int = 64
    n_generations: int = 40
    seed: int = 0
    seed_exact: bool = True         # inject the exact design into the init pop
    # a `launch.mesh.make_search_mesh` spec (None = one device; "auto"/"4"
    # split the population over the ranks; islands: the ring's size). The
    # checkpoints do not depend on it, so a run may resume on another mesh
    mesh: str | None = None
    # the JAX package's kernel-backend tiles, accepted with its defaults and
    # ignored: they tile the Pallas grid (DESIGN.md §12), and the CUDA
    # kernels choose their own tiles, so they change no result
    block_p: int = 8
    block_b: int = 256
    block_l: int | None = None
    interpret: bool | None = None
    # islands backend (generations round UP to whole migration rounds;
    # checkpoints land on round boundaries)
    migrate_every: int = 5
    n_migrate: int = 4
    dataset: str | None = None      # dataset label recorded in pareto.json
    out_dir: str | None = None
    checkpoint_every: int = 0       # generations between saves; 0 = off
    resume: bool = False
    emit_rtl: bool = False          # write per-pareto-point Verilog (OUT/rtl/)
    verify_rtl: bool = False        # netlist-simulate every pareto point and
                                    # require it to equal the tensor predict
                                    # and the family's kernel route


@dataclasses.dataclass
class SearchResult:
    state: nsga2.NSGA2State
    pareto_objs: np.ndarray    # (K, 2) accuracy-loss / normalized-area
    pareto_genes: np.ndarray   # (K, n_genes)
    backend: str
    wall_s: float
    n_evaluations: int
    n_dispatches: int = 0      # generation-loop calls from the host

    def best_under_loss(self, max_loss: float = 0.01):
        """Smallest-area pareto point within an accuracy-loss budget."""
        ok = self.pareto_objs[:, 0] <= max_loss + 1e-9
        if not ok.any():
            return None
        idx = np.flatnonzero(ok)
        best = idx[np.argmin(self.pareto_objs[idx, 1])]
        return self.pareto_objs[best], self.pareto_genes[best]


def _ckpt_dir(cfg: SearchConfig) -> str | None:
    return os.path.join(cfg.out_dir, "ckpt") if cfg.out_dir else None


def _chunk_schedule(start: int, stop: int, every: int) -> list[int]:
    """Chunk lengths covering [start, stop) with boundaries at multiples of
    ``every`` (every = 0: one chunk for the rest of the run). A resume from
    an off-boundary final save realigns at the next multiple, so
    checkpoints land on the same cadence whatever the interruptions."""
    if every < 0:
        raise ValueError(f"checkpoint_every must be >= 0, got {every}")
    if start >= stop:
        return []
    if not every:
        return [stop - start]
    out = []
    g = start
    while g < stop:
        nxt = min(stop, (g // every + 1) * every)
        out.append(nxt - g)
        g = nxt
    return out


def _drive_chunks(state, start: int, stop: int, every: int, make_chunk_fn,
                  save_fn=None):
    """Run positions [start, stop) as chunks with boundaries at multiples of
    ``every``, making one chunk function per distinct length (at most
    three: the realignment after an off-boundary resume, the steady
    ``every``-long chunk and a shorter tail; on the card each is one
    captured graph). ``save_fn`` is called at every boundary and, unless
    that position was just saved, once at the end, so a partial run always
    leaves its final state on disk. Returns (state, position, n_chunks)."""
    chunk_fns = {}
    cur = start
    last_saved = start if start else -1
    n_chunks = 0
    for length in _chunk_schedule(start, stop, every):
        fn = chunk_fns.get(length)
        if fn is None:
            fn = chunk_fns[length] = make_chunk_fn(length)
        state = fn(state)
        cur += length
        n_chunks += 1
        if save_fn and every and cur % every == 0:
            save_fn(cur, state)
            last_saved = cur
    if save_fn and last_saved != cur:
        save_fn(cur, state)
    return state, cur, n_chunks


def _validate_resume_meta(ckpt_dir: str, step: int, family: str,
                          cfg: SearchConfig, n_islands: int = 0) -> dict:
    """Refuse a checkpoint whose layout cannot match this run: another
    driver family, another pop size, a state not drawn from a torch
    generator (a JAX checkpoint keeps a threefry key there), or for the
    islands another migration grid or number of islands. Returns the
    manifest's meta."""
    from repro_torch.runtime import checkpoint

    meta = checkpoint.read_manifest(ckpt_dir, step).get("meta", {})
    where = f"checkpoint at {ckpt_dir} step {step}"
    saved = meta.get("family")
    if saved != family:
        raise ValueError(
            f"{where} was written by the {saved!r} driver; cannot resume it "
            f"with backend={cfg.backend!r} ({family!r} state layout)")
    if meta.get("pop_size", cfg.pop_size) != cfg.pop_size:
        raise ValueError(
            f"{where} was written with pop_size={meta['pop_size']}; cannot "
            f"resume with pop_size={cfg.pop_size}")
    if meta.get("rng") != "torch":
        raise ValueError(
            f"{where} holds rng={meta.get('rng')!r} state, not a torch "
            f"generator's (a JAX search checkpoint keeps a threefry key); "
            f"cannot resume it in the port")
    if family != "islands":
        return meta
    if meta.get("migrate_every", cfg.migrate_every) != cfg.migrate_every:
        raise ValueError(
            f"islands checkpoint at step {step} was written with "
            f"migrate_every={meta['migrate_every']}; resuming with "
            f"migrate_every={cfg.migrate_every} would shift the round grid")
    if meta.get("n_islands", n_islands) != n_islands:
        raise ValueError(
            f"islands checkpoint at step {step} was written on "
            f"{meta['n_islands']} islands; this mesh has {n_islands} ranks "
            f"(per-island populations would not line up)")
    return meta


def _state_leaves(state: nsga2.NSGA2State, generator: torch.Generator):
    """Checkpoint leaves in the JAX package's `NSGA2State` order: genes,
    objs, rank, crowd, the RNG (the generator's state where JAX keeps its
    key) and the generation."""
    return (state.genes, state.objs, state.rank, state.crowd,
            generator.get_state(), np.int32(state.generation))


def _restore_template(problem, cfg: SearchConfig, generator: torch.Generator):
    """Leaves of the shapes and dtypes `_state_leaves` saves, for
    `checkpoint.restore`; no fitness evaluation."""
    p, dev = cfg.pop_size, problem.device
    return (torch.zeros((p, problem.n_genes), dtype=torch.float32, device=dev),
            torch.zeros((p, 2), dtype=torch.float32, device=dev),
            torch.zeros((p,), dtype=torch.int32, device=dev),
            torch.zeros((p,), dtype=torch.float32, device=dev),
            generator.get_state(), torch.zeros((), dtype=torch.int32))


def _save(ckpt_dir: str, step: int, leaves, meta: dict) -> None:
    """Write a checkpoint on rank 0 alone; every rank waits for it."""
    from repro_torch.launch import mesh as _mesh
    from repro_torch.runtime import checkpoint

    if _mesh.is_writer():
        checkpoint.save(ckpt_dir, step, leaves, meta=meta)
    _mesh.barrier()


def _run_single(problem, cfg: SearchConfig, fitness, mesh=None):
    """The chunked generation loop with checkpoint/resume. Returns (state,
    n_evaluations, n_dispatches) for this call.

    With a mesh the same schedule runs through `dist.make_sharded_chunk`
    on this rank's slab; every rank seeds the same generator, restores
    the whole saved state and keeps its slab, and the saves hold the
    gathered state and the one replicated generator state (checked equal
    on every rank), so they are the single-device run's."""
    from repro_torch.core import dist
    from repro_torch.runtime import checkpoint
    from repro_torch.sharding import search as _specs

    device = problem.device
    nsga_cfg = nsga2.NSGA2Config(pop_size=cfg.pop_size,
                                 n_generations=cfg.n_generations)
    if mesh is not None:
        specs = dist.sharded_state_sharding(mesh)
        group = mesh.get_group("pop")
        n_shards = _specs.axis_extent(mesh, "pop")
        if cfg.pop_size % n_shards:
            raise ValueError(
                f"pop_size={cfg.pop_size} not divisible by the mesh's "
                f"pop axis ({n_shards})")
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.seed)
    state = None
    start_gen = n_evals = n_dispatches = 0
    ckpt_dir = _ckpt_dir(cfg)
    meta = {"family": "single", "backend": cfg.backend,
            "pop_size": cfg.pop_size, "rng": "torch"}
    if cfg.resume and ckpt_dir:
        step = checkpoint.latest_step(ckpt_dir)
        if step is not None:
            _validate_resume_meta(ckpt_dir, step, "single", cfg)
            leaves, start_gen = checkpoint.restore(
                ckpt_dir, step, _restore_template(problem, cfg, generator))
            genes, objs, rank, crowd, rng_state, _ = leaves
            generator.set_state(rng_state)
            state = nsga2.NSGA2State(genes, objs, rank, crowd, start_gen)
            if mesh is not None:
                dist.assert_replicated(generator.get_state(), group,
                                       "the restored generator state")
                state = _specs.shard_state(state, mesh, specs)

    if state is None:
        seed_genes = problem.exact_genes() if cfg.seed_exact else None
        if mesh is not None:
            state = dist.init_sharded(generator, fitness, problem.n_genes,
                                      mesh, nsga_cfg, seed_genes=seed_genes)
        else:
            draws = nsga2.draw_init(generator, cfg.pop_size, problem.n_genes,
                                    nsga2.seed_count(seed_genes), device)
            state = nsga2.init_state(fitness, nsga_cfg, draws,
                                     seed_genes=seed_genes)
        n_evals += cfg.pop_size
        n_dispatches += 1

    def make_chunk_fn(length):
        if mesh is not None:
            chunk = dist.make_sharded_chunk(fitness, mesh, nsga_cfg, length)
        else:
            chunk = nsga2.make_chunk(fitness, nsga_cfg, length)
        return lambda s: chunk(s, generator)

    def whole(s):
        return s if mesh is None else dist.gather_state(s, mesh, specs)

    def save(gen, s):
        if mesh is not None:
            dist.assert_replicated(generator.get_state(), group,
                                   "the generator state")
        _save(ckpt_dir, gen, _state_leaves(whole(s), generator), meta)

    # no out_dir: nothing to save, so checkpoint_every does not shrink the
    # chunks (the whole run stays one dispatch)
    saving = bool(ckpt_dir and cfg.checkpoint_every)
    state, cur_gen, n_chunks = _drive_chunks(
        state, start_gen, cfg.n_generations,
        cfg.checkpoint_every if saving else 0, make_chunk_fn,
        save if saving else None)
    n_evals += cfg.pop_size * (cur_gen - start_gen)
    n_dispatches += n_chunks
    return whole(state), n_evals, n_dispatches


def _islands_template(problem, n_islands: int, local_pop: int,
                      generator: torch.Generator):
    """Leaves of the gathered islands state for `checkpoint.restore`: the
    islands' rows in ring order and one generator state per island."""
    p, dev = n_islands * local_pop, problem.device
    rng = generator.get_state()
    return (torch.zeros((p, problem.n_genes), dtype=torch.float32, device=dev),
            torch.zeros((p, 2), dtype=torch.float32, device=dev),
            torch.zeros((p,), dtype=torch.int32, device=dev),
            torch.zeros((p,), dtype=torch.float32, device=dev),
            torch.zeros((n_islands, *rng.shape), dtype=rng.dtype),
            torch.zeros((), dtype=torch.int32))


def _run_islands(problem, cfg: SearchConfig):
    """One NSGA-II island a rank of the ``data`` ring, ring migration.

    Generations round UP to whole migration rounds (``migrate_every``
    each), so the islands may run more generations than configured;
    `n_evaluations` counts what ran. Rounds run as `dist.make_island_chunk`
    calls sized to the checkpoint cadence: checkpoints land on round
    boundaries, every ceil(checkpoint_every / migrate_every) rounds,
    labelled in generations, and hold the gathered islands and every
    island's generator state; a resume hands each rank its island's.
    Returns (the gathered state, n_evaluations, n_dispatches)."""
    from repro_torch.core import dist
    from repro_torch.families import family_of
    from repro_torch.launch.mesh import make_search_mesh
    from repro_torch.runtime import checkpoint
    from repro_torch.sharding import search as _specs

    # the fitness the JAX package's islands use
    fitness = family_of(problem).make_fitness(problem, "reference")
    # one mesh constructor for every driver; islands default to a ring
    # over every card
    mesh = make_search_mesh(cfg.mesh or "auto", axes=("data",),
                            device=problem.device)
    n_islands = _specs.axis_extent(mesh, "data")
    specs = dist.island_state_sharding(mesh)
    local_pop = max(8, cfg.pop_size // n_islands)
    island_cfg = dist.IslandConfig(
        local_pop=local_pop, migrate_every=cfg.migrate_every,
        n_migrate=min(cfg.n_migrate, local_pop // 2),
        nsga=nsga2.NSGA2Config(pop_size=local_pop,
                               n_generations=cfg.n_generations))
    n_rounds = max(1, -(-cfg.n_generations // cfg.migrate_every))
    ckpt_rounds = (max(1, -(-cfg.checkpoint_every // cfg.migrate_every))
                   if cfg.checkpoint_every else 0)

    state = generator = None
    start_round = n_evals = n_dispatches = 0
    ckpt_dir = _ckpt_dir(cfg)
    meta = {"family": "islands", "backend": cfg.backend,
            "pop_size": cfg.pop_size, "local_pop": local_pop,
            "n_islands": n_islands, "migrate_every": cfg.migrate_every,
            "rng": "torch"}
    if cfg.resume and ckpt_dir:
        step = checkpoint.latest_step(ckpt_dir)
        if step is not None:
            _validate_resume_meta(ckpt_dir, step, "islands", cfg, n_islands)
            generator = torch.Generator(device=problem.device)
            leaves, gens_done = checkpoint.restore(
                ckpt_dir, step, _islands_template(problem, n_islands,
                                                  local_pop, generator))
            genes, objs, rank, crowd, rng_states, _ = leaves
            state = _specs.shard_state(
                nsga2.NSGA2State(genes, objs, rank, crowd, gens_done),
                mesh, specs)
            # a copy: set_state crashes on a view at a storage offset
            generator.set_state(_specs.split(rng_states, specs["generator"],
                                             mesh)[0].clone())
            start_round = gens_done // cfg.migrate_every

    if state is None:
        state, generator = dist.init_islands(
            cfg.seed, fitness, problem.n_genes, mesh, island_cfg,
            seed_genes=problem.exact_genes() if cfg.seed_exact else None,
            device=problem.device)
        n_evals += n_islands * local_pop
        n_dispatches += 1

    def make_chunk_fn(n):
        chunk = dist.make_island_chunk(fitness, mesh, island_cfg, n)
        return lambda s: chunk(s, generator)

    def save(rnd, s):
        # the JAX package's leaves, one generator state per island where it
        # keeps one key per island
        whole = dist.gather_state(s, mesh, specs)
        rng = dist.gather(generator.get_state()[None], specs["generator"],
                          mesh)
        _save(ckpt_dir, rnd * cfg.migrate_every,
              (whole.genes, whole.objs, whole.rank, whole.crowd, rng,
               np.int32(rnd * cfg.migrate_every)), meta)

    saving = bool(ckpt_dir and ckpt_rounds)
    state, cur_round, n_chunks = _drive_chunks(
        state, start_round, n_rounds, ckpt_rounds if saving else 0,
        make_chunk_fn, save if saving else None)
    n_gens = cur_round * cfg.migrate_every
    n_evals += n_islands * local_pop * (cur_round - start_round) \
        * cfg.migrate_every
    n_dispatches += n_chunks
    whole = dist.gather_state(state, mesh, specs)
    return (nsga2.NSGA2State(whole.genes, whole.objs, whole.rank,
                             whole.crowd, n_gens), n_evals, n_dispatches)



def run_search(problem, cfg: SearchConfig | None = None,
               **overrides) -> SearchResult:
    """Search the problem's design space on its device; `overrides` are
    applied on top of `cfg` (or a default SearchConfig)."""
    cfg = dataclasses.replace(cfg or SearchConfig(), **overrides)
    backends = (*_backends.BACKENDS, "islands")
    if cfg.backend not in backends:
        raise ValueError(
            f"unknown backend {cfg.backend!r}; options: {backends}")
    if cfg.checkpoint_every < 0:
        raise ValueError(
            f"checkpoint_every must be >= 0, got {cfg.checkpoint_every}")
    if (cfg.emit_rtl or cfg.verify_rtl) and not cfg.out_dir:
        raise ValueError("emit_rtl/verify_rtl require out_dir")
    if cfg.pop_size < 2 or cfg.pop_size % 2:
        raise ValueError(f"pop_size must be even and >= 2, got {cfg.pop_size}")

    from repro_torch.launch import mesh as _mesh

    t0 = time.time()
    if cfg.backend == "islands":
        state, n_evals, n_dispatches = _run_islands(problem, cfg)
    else:
        fitness = _backends.make_fitness(problem, cfg.backend)
        mesh = _mesh.make_search_mesh(cfg.mesh, axes=("pop",),
                                      device=problem.device)
        state, n_evals, n_dispatches = _run_single(problem, cfg, fitness,
                                                   mesh=mesh)
    objs, genes = nsga2.pareto_front(state.objs, state.genes)
    wall_s = time.time() - t0

    result = SearchResult(
        state=state,
        pareto_objs=objs,
        pareto_genes=genes,
        backend=cfg.backend,
        wall_s=wall_s,
        n_evaluations=n_evals,
        n_dispatches=n_dispatches,
    )
    if cfg.out_dir and _mesh.is_writer():
        from repro_torch.families import family_of

        family_of(problem).write_artifact(
            problem, result, cfg.out_dir, emit_rtl=cfg.emit_rtl,
            verify_rtl=cfg.verify_rtl, dataset=cfg.dataset)
    _mesh.barrier()
    return result


def _make_kernel_predict(problem: SearchProblem):
    """Single chromosome (3N+1,) -> (B,) predictions through the
    `tree_infer_scores` kernel: the third leg of the RTL verification
    triangle."""
    from repro_torch.kernels import ops as kops

    operands = kops.prepare_operands(
        problem.feature, problem.path, problem.path_len, problem.n_neg,
        problem.leaf_class, problem.n_classes, problem.n_features)

    def predict(genes):
        shift, thr, vote_cap = kops.decode_population(
            problem.threshold, genes[None, :])
        return kops.tree_infer_predict(problem.x8, operands, shift, thr,
                                       vote_cap)[0]

    return predict


def netlist_area_ratios(points) -> list[float]:
    """Per-point netlist/LUT area ratio from `pareto.json` points (the
    paper's Fig. 5 estimated-vs-actual gap); zero-area points skipped."""
    return [p["area_netlist_mm2"] / p["area_mm2"] for p in points
            if p["area_mm2"] > 0]


def write_pareto_artifact(problem: SearchProblem, result: SearchResult,
                          out_dir: str, *, emit_rtl: bool = False,
                          verify_rtl: bool = False,
                          dataset: str | None = None) -> str:
    """pareto.json: objectives + genes + decoded designs + hardware artifact.

    Every point records the decoded `bits`/`margin`/`t_int` (pre-truncation),
    `trunc` and `vote_adder`, the LUT area estimate beside the netlist area,
    and the file carries the tree layout, so a design re-materializes from
    the artifact alone. emit_rtl writes each point's Verilog under OUT/rtl/;
    verify_rtl simulates each point's netlist over the test set and asserts
    it equals `predict_votes` and the `tree_infer_scores` kernel.
    """
    from repro_torch.core import netlist, rtl
    from repro_torch.search import artifact as _artifact
    from repro_torch.search.problem import predict_votes, problem_ptrees

    os.makedirs(out_dir, exist_ok=True)
    ptrees = problem_ptrees(problem)
    if emit_rtl:
        os.makedirs(os.path.join(out_dir, "rtl"), exist_ok=True)
    kernel_predict = _make_kernel_predict(problem) if verify_rtl else None

    points = []
    for i, (o, g) in enumerate(zip(result.pareto_objs, result.pareto_genes)):
        g_t = torch.as_tensor(g, dtype=torch.float32, device=problem.device)
        bits_t, margin_t, trunc_t, vote_t = quant.decode_tree_genes(g_t)
        t_sub_t = quant.substitute(
            quant.threshold_to_int(problem.threshold, bits_t), margin_t,
            bits_t)
        bits = bits_t.cpu().numpy()
        t_sub = t_sub_t.cpu().numpy()
        trunc = trunc_t.cpu().numpy()
        vote_adder = "approx" if int(vote_t) else "exact"
        circuit = netlist.build_circuit(ptrees, bits, t_sub,
                                        problem.n_classes, trunc=trunc,
                                        vote_adder=vote_adder)
        point = {
            "acc_loss": float(o[0]),
            "norm_area": float(o[1]),
            "area_mm2": float(o[1] * problem.exact_area_mm2),
            "area_netlist_mm2": round(netlist.netlist_area_mm2(circuit), 4),
            "netlist_gates": netlist.gate_counts(circuit),
            "bits": bits.tolist(),
            "margin": margin_t.cpu().numpy().tolist(),
            "t_int": t_sub.tolist(),
            "trunc": trunc.tolist(),
            "vote_adder": vote_adder,
            "genes": np.asarray(g, np.float64).round(6).tolist(),
        }
        if emit_rtl:
            verilog = rtl.emit_design(ptrees, bits, t_sub, problem.n_classes,
                                      trunc=trunc, vote_adder=vote_adder)
            rel = os.path.join("rtl", f"point_{i:02d}.v")
            with open(os.path.join(out_dir, rel), "w") as f:
                f.write(verilog)
            point["rtl"] = rel
        if verify_rtl:
            sim = netlist.simulate(circuit, problem.x8).cpu().numpy()
            ref = predict_votes(problem, bits_t - trunc_t, t_sub_t >> trunc_t,
                                quant.vote_cap_of(vote_t)).cpu().numpy()
            ker = kernel_predict(g_t).cpu().numpy()
            if not (np.array_equal(sim, ref) and np.array_equal(sim, ker)):
                n_ref = int((sim != ref).sum())
                n_ker = int((sim != ker).sum())
                raise AssertionError(
                    f"pareto point {i}: netlist simulation diverges from "
                    f"predict_votes on {n_ref} and from the kernel backend "
                    f"on {n_ker} of {sim.shape[0]} test samples")
            point["verified"] = True
        points.append(point)

    payload = {
        "family": "tree",
        "backend": result.backend,
        "wall_s": round(result.wall_s, 3),
        "n_evaluations": result.n_evaluations,
        "n_dispatches": result.n_dispatches,
        "n_trees": problem.n_trees,
        "n_comparators": problem.n_comparators,
        "n_classes": problem.n_classes,
        "tree_comparators": list(problem.tree_comparators),
        "tree_leaves": list(problem.tree_leaves),
        "feature": problem.feature.cpu().numpy().tolist(),
        "threshold": np.asarray(problem.threshold.cpu().numpy(), np.float64)
                       .round(8).tolist(),
        "path": problem.path.cpu().numpy().tolist(),
        "path_len": problem.path_len.cpu().numpy().tolist(),
        "n_neg": problem.n_neg.cpu().numpy().tolist(),
        "leaf_class": problem.leaf_class.cpu().numpy().tolist(),
        "exact_accuracy": problem.exact_accuracy,
        "exact_area_mm2": problem.exact_area_mm2,
        "rtl_verified": bool(verify_rtl),
        "pareto": points,
    }
    if dataset is not None:
        payload["dataset"] = dataset
    _artifact.validate_payload(payload, where="write_pareto_artifact")
    path = os.path.join(out_dir, "pareto.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, path)
    return path
