"""Multi-pod dry run: what every (arch x shape x mesh) cell costs a rank.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        [--arch A|all|paper-dt-ga] [--shape S|all] \
        [--mesh single|multi|both] [--force] [--out DIR]

The counterpart of `repro.launch.dryrun`, with its flags, cells and
record keys. Where the JAX package lowers and compiles each cell's
jitted step against placeholder devices, the port runs the cell's own
sharded step once on meta tensors (shapes and dtypes, no data, no
memory) in one rank of a ``fake`` process group of 256 ranks (the 16x16
``(data, model)`` mesh) or 512 (2x16x16 with ``pod``), from
`launch.mesh.make_production_mesh`: the collectives are `core.comm`'s,
counted and moving nothing, and the attention kernel's meta branch
allocates what the card's does and reports its FLOPs
(`kernels.flash_attn`). `launch.step_analysis.analyze` records the rank's
FLOPs, its HBM-traffic proxy, its collectives and its memory. So the dry
run answers, per rank, whether a cell fits, how many FLOPs it runs and
how many collective bytes it moves, from the port's own code.

Cells (`build_cell`): ``train_*`` runs `runtime.train.make_train_step(cfg,
rules)` on the rank's state (`sharding.params.init_sharded_params`,
`runtime.train.init_sharded_train_state`) and the global batch of
`data.make_batch_specs` (the step cuts its own rows); ``prefill_*`` runs
`runtime.lm_serve.make_prefill_step(cfg, s_max, rules)` on the rank's
rows of that batch; ``decode_*`` and ``long_*`` one
`make_serve_step(cfg, rules)` token at the cache's last position against
the rank's blocks of `models.lm.init_caches(..., rules=)`. Ranks do
different work (the last model rank of a replicated-head attention runs
the whole sequence, rank 0 the first block of it), so each cell runs at
rank 0 and at the last rank, each in a fresh fake group; the record keeps
both under ``ranks`` and reports the larger of each number.

`run_ga_cell` is the paper's own workload: one island-model NSGA-II round
(4 generations and a ring migration) of the pendigits tree's search, one
island of 32 a ``data`` rank, on CPU tensors (the reference fitness and
the plain peel read their data; the fake gather leaves the migrants
unset, which ends the round and changes no count).

Records go to ``build/dryrun/<mesh>/<arch>__<shape>.json`` (git-ignored;
`--out` elsewhere) and are resumable: an existing record is kept unless
``--force``. There is no ``.hlo.gz``: no compiled program exists, and the
analysis runs the step itself. The device is meta (the GA cell's, the
CPU) by design, as the JAX dry run runs on placeholder host devices: the
dry run starts no CUDA context.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shapes_for
from repro_torch.launch import step_analysis
from repro_torch.launch.mesh import PRODUCTION, make_production_mesh, rules_for

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
MESH_NAMES = {False: "pod16x16", True: "pod2x16x16"}
collective_stats = step_analysis.collective_stats   # the JAX module's name


@contextlib.contextmanager
def fake_group(world_size: int, rank: int):
    """This process as rank ``rank`` of a ``fake`` group of ``world_size``
    ranks (`torch.testing._internal.distributed.fake_pg`): collectives
    complete at once and move nothing. The group is destroyed on exit, so
    the next rank starts fresh: `sharding.spmd.layout`'s cache is cleared
    with it (a mesh of the next group compares equal to this one's, and
    its cached groups would be this group's)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.sharding.spmd import layout

    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process with no group: this "
                           "one is a rank of one already")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
        layout.cache_clear()


def n_ranks(multi_pod: bool) -> int:
    return math.prod(PRODUCTION[multi_pod][0])


def cell_inputs(cfg, shape, mesh):
    """(fn, args) of a ``shape`` cell (a `configs.ShapeConfig`) of ``cfg``
    on this rank of ``mesh``: the step and the rank's inputs, meta
    tensors."""
    from repro_torch.data.pipeline import make_batch_specs
    from repro_torch.models import lm
    from repro_torch.optim import get_optimizer
    from repro_torch.runtime import lm_serve
    from repro_torch.runtime import train as train_rt
    from repro_torch.sharding import params as sp

    rules = rules_for(mesh)
    params = sp.init_sharded_params(0, cfg, rules, mesh, device="meta")
    batch = make_batch_specs(cfg, shape)
    if shape.kind == "train":
        opt = get_optimizer(cfg)
        state = train_rt.init_sharded_train_state(params, opt, cfg, rules)
        return train_rt.make_train_step(cfg, rules, opt), (state, batch)
    if shape.kind == "prefill":
        specs = sp.batch_specs(cfg, rules, sp.mesh_axes(mesh), batch)
        rows = {k: sp.shard(v, specs[k], mesh) for k, v in batch.items()}
        return (lm_serve.make_prefill_step(cfg, shape.seq_len, rules),
                (params, rows))
    caches = lm.init_caches(cfg, shape.global_batch, shape.seq_len,
                            rules=rules, device="meta")
    lead = next(iter(caches.values()))[0]
    token = torch.zeros((lead.shape[1], 1), dtype=torch.int32, device="meta")
    return (lm_serve.make_serve_step(cfg, rules),
            (params, token, caches, shape.seq_len - 1))


def build_cell(arch: str, shape_name: str, mesh):
    """(fn, args) of the (arch, shape) cell on this rank of ``mesh``
    (`cell_inputs`)."""
    return cell_inputs(get_config(arch), SHAPES[shape_name], mesh)


def timed_analysis(fn, args) -> dict:
    """`step_analysis.analyze` of ``fn(*args)``, with its ``seconds``."""
    t0 = time.perf_counter()
    out = step_analysis.analyze(fn, *args)
    out["seconds"] = round(time.perf_counter() - t0, 2)
    return out


def analyze_rank(arch: str, shape_name: str, multi_pod: bool,
                 rank: int) -> dict:
    """The cell's analysis at ``rank`` of a fresh fake group of the
    production mesh's size."""
    with fake_group(n_ranks(multi_pod), rank):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        return timed_analysis(*build_cell(arch, shape_name, mesh))


def _largest(per_rank: list) -> dict:
    """Each number's largest value over the ranks' analyses."""
    first = per_rank[0]
    if isinstance(first, dict):
        return {k: _largest([r[k] for r in per_rank]) for k in first}
    return max(per_rank)


def _run(arch: str, shape: str, multi_pod: bool, out_dir, force: bool,
         device: str, analyze) -> dict:
    """The record of a cell, from its file unless ``force``: ``analyze(rank)``
    at rank 0 and at the last rank under ``ranks``, their larger numbers as
    the record's ``memory``, ``cost`` and ``collectives`` (and any other
    key the analyses carry); a failure's error and traceback where it
    failed."""
    mesh_name = MESH_NAMES[multi_pod]
    path = Path(out_dir or RESULTS_DIR) / mesh_name / f"{arch}__{shape}.json"
    if path.exists() and not force:
        return json.loads(path.read_text())
    n = n_ranks(multi_pod)
    record = {"arch": arch, "shape": shape, "mesh": mesh_name,
              "n_devices": n, "device": device}
    try:
        ranks = {str(r): analyze(r) for r in (0, n - 1)}
        top = _largest(list(ranks.values()))
        extra = {k: v for k, v in top.items() if k not in (
            "flops", "bytes", "kernel_flops", "seconds")}
        record.update(ranks=ranks, **extra,
                      cost={"flops": top["flops"],
                            "bytes_accessed": top["bytes"]}, status="ok")
    except Exception as e:  # noqa: BLE001 — failures are data here
        record.update(status="fail", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, indent=1))
    return record


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir=None,
             force: bool = False) -> dict:
    """The (arch, shape) cell's record on the production mesh (`_run`)."""
    return _run(arch, shape_name, multi_pod, out_dir, force, "meta",
                lambda r: analyze_rank(arch, shape_name, multi_pod, r))


def _ga_problem():
    """The pendigits tree's search problem on the CPU and its reference
    fitness."""
    from repro_torch.core import approx
    from repro_torch.core.train import train_tree
    from repro_torch.core.tree import to_parallel
    from repro_torch.datasets import load_dataset

    ds = load_dataset("pendigits")
    pt = to_parallel(train_tree(ds.x_train, ds.y_train, ds.n_classes))
    prob = approx.build_problem(pt, ds.x_test, ds.y_test, device="cpu")
    return prob, approx.make_fitness_fn(prob)


def _ga_round(prob, fit, multi_pod: bool, rank: int) -> dict:
    """The GA cell's analysis at ``rank``, with its sizes."""
    from repro_torch.core import dist as ga_dist
    from repro_torch.core import nsga2

    cfg = ga_dist.IslandConfig(local_pop=32, migrate_every=4, n_migrate=4,
                               nsga=nsga2.NSGA2Config(pop_size=32))
    with fake_group(n_ranks(multi_pod), rank):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        state, gen = ga_dist.init_islands(0, fit, prob.n_genes, mesh, cfg,
                                          device="cpu")
        out = timed_analysis(ga_dist.make_island_step(fit, mesh, cfg),
                             (state, gen))
        n_islands = mesh.size(mesh.mesh_dim_names.index("data"))
    out.update(n_comparators=prob.n_comparators,
               global_population=n_islands * cfg.local_pop)
    return out


def run_ga_cell(multi_pod: bool, out_dir=None, force: bool = False) -> dict:
    """The paper's workload at production scale (see the module
    docstring), recorded as `run_cell` records a cell, with
    ``n_comparators`` and ``global_population``."""
    problem = []

    def analyze(rank):
        if not problem:
            problem.extend(_ga_problem())
        return _ga_round(*problem, multi_pod, rank)

    return _run("paper-dt-ga", "islands", multi_pod, out_dir, force, "cpu",
                analyze)


def summary(rec: dict) -> str:
    """One line of a record: the rank's peak GiB, GFLOP and collective
    MiB (each the larger rank's)."""
    head = f"{rec['arch']:18s} {rec['shape']:12s} {rec['mesh']:10s}"
    if rec["status"] != "ok":
        return f"[FAIL] {head} {rec['error'][:160]}"
    peak = rec["memory"]["peak_bytes"] / 2**30
    gflop = rec["cost"]["flops"] / 1e9
    coll = rec["collectives"]["total_bytes"] / 2**20
    return (f"[OK]   {head} peak/dev={peak:8.2f}GiB GFLOP/dev={gflop:11.1f} "
            f"coll={coll:10.1f}MiB")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None,
                    choices=ARCH_IDS + ["all", "paper-dt-ga"])
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    records = []
    if args.arch == "paper-dt-ga":
        records = [run_ga_cell(mp, args.out, args.force) for mp in meshes]
        for rec in records:
            print(summary(rec), flush=True)
    else:
        archs = ARCH_IDS if args.arch in (None, "all") else [args.arch]
        for arch in archs:
            shapes = shapes_for(get_config(arch)) if args.shape == "all" \
                else [args.shape]
            for shape in shapes:
                for mp in meshes:
                    rec = run_cell(arch, shape, mp, args.out, args.force)
                    records.append(rec)
                    print(summary(rec), flush=True)
    return 0 if all(r["status"] == "ok" for r in records) else 1


if __name__ == "__main__":
    raise SystemExit(main())
