"""Island-model distributed NSGA-II with checkpoint/restart, on the
PyTorch/CUDA port.

The paper's search as it would run across many cards, scaled down to 8
ranks: one island a rank of a ``data`` ring, elite migration around the
ring, a checkpoint every round, then a simulated failure and an ELASTIC
restart on 4 ranks from the last checkpoint, each rank then holding two
islands' rows (48). The counterpart of `examples/distributed_ga.py`: where
it forces 8 host devices with ``XLA_FLAGS``, this one spawns 8 ranks with
`repro_torch.launch.mesh.spawn` (gloo when ranks share a card or run on
the CPU). ``--device`` (default ``cuda``; ``--device cpu`` for the CPU):

    PYTHONPATH=src python examples/torch_distributed_ga.py [--device cpu]
"""
import argparse
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.core import approx, dist, nsga2
from repro_torch.core.train import train_tree
from repro_torch.core.tree import to_parallel
from repro_torch.datasets import load_dataset
from repro_torch.launch import mesh as launch_mesh
from repro_torch.runtime import checkpoint
from repro_torch.sharding import search as specs_mod

N_ISLANDS = 8
CFG = dist.IslandConfig(local_pop=24, migrate_every=4, n_migrate=3,
                        nsga=nsga2.NSGA2Config(pop_size=24))


def _problem(device):
    ds = load_dataset("cardio")
    pt = to_parallel(train_tree(ds.x_train, ds.y_train, ds.n_classes))
    prob = approx.build_problem(pt, ds.x_test, ds.y_test, device=device)
    return pt, prob, approx.make_fitness_fn(prob)


def _report(state, mesh, what: str) -> None:
    objs, _ = dist.gathered_pareto(state, mesh)
    best = objs[objs[:, 0] <= 0.01]
    area = best[:, 1].min() if len(best) else float("nan")
    if launch_mesh.is_writer():
        print(f"{what}: pareto={len(objs)} best_area@1%={area:.3f}",
              flush=True)


def search_ranks(device: str, ckpt_dir: str) -> None:
    """One island on this rank of the 8: 4 rounds, a checkpoint of the
    gathered islands (and every island's generator) after each."""
    dev = launch_mesh.rank_device(device)
    pt, prob, fit = _problem(dev)
    mesh = launch_mesh.make_host_mesh(device=dev)
    if launch_mesh.is_writer():
        print(f"ranks: {N_ISLANDS} (islands) on {dev.type}")
        print(f"cardio: {pt.n_comparators} comparators, "
              f"exact acc {prob.exact_accuracy:.3f}", flush=True)
    specs = dist.island_state_sharding(mesh)
    state, gen = dist.init_islands(0, fit, prob.n_genes, mesh, CFG,
                                   device=dev)
    step = dist.make_island_step(fit, mesh, CFG)
    for rnd in range(4):
        state = step(state, gen)
        whole = dist.gather_state(state, mesh, specs)
        rng = dist.gather(gen.get_state()[None], specs["generator"], mesh)
        if launch_mesh.is_writer():
            checkpoint.save(ckpt_dir, rnd, (
                whole.genes, whole.objs, whole.rank, whole.crowd, rng,
                np.int32(whole.generation)))
        launch_mesh.barrier()
        _report(state, mesh, f"round {rnd}")


def restart_ranks(device: str, ckpt_dir: str) -> int:
    """This rank of the 4 after the failure: its block of the 8 islands'
    checkpoint (two islands' rows, and the first one's generator), two
    more rounds with the block as its island. Returns its rows."""
    dev = launch_mesh.rank_device(device)
    _, prob, fit = _problem(dev)
    mesh = launch_mesh.make_host_mesh(device=dev)
    gen = torch.Generator(device=dev)
    rng = gen.get_state()
    p = N_ISLANDS * CFG.local_pop
    like = (torch.zeros((p, prob.n_genes), device=dev),
            torch.zeros((p, 2), device=dev),
            torch.zeros((p,), dtype=torch.int32, device=dev),
            torch.zeros((p,), device=dev),
            torch.zeros((N_ISLANDS, *rng.shape), dtype=rng.dtype),
            torch.zeros((), dtype=torch.int32))
    leaves, _ = checkpoint.restore(ckpt_dir, checkpoint.latest_step(ckpt_dir),
                                   like)
    genes, objs, rank, crowd, rng_states, generation = leaves
    specs = dist.island_state_sharding(mesh)
    # the population re-shards onto the smaller mesh; islands continue
    state = specs_mod.shard_state(nsga2.NSGA2State(
        genes, objs, rank, crowd, int(generation)), mesh, specs)
    # a copy: set_state refuses a view at a storage offset
    gen.set_state(specs_mod.split(rng_states, specs["generator"],
                                  mesh)[0].clone())
    step = dist.make_island_step(fit, mesh, CFG)
    rows = state.genes.shape[0]
    for rnd in range(2):
        state = step(state, gen)
        _report(state, mesh, f"post-failure round {rnd}")
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of every rank (default cuda; cpu "
                         "for the CPU)")
    args = ap.parse_args()
    ckpt_dir = tempfile.mkdtemp(prefix="ga_ckpt_")
    try:
        launch_mesh.spawn(search_ranks, N_ISLANDS, args.device,
                          (args.device, ckpt_dir))
        # ---- simulated failure: restart on HALF the ranks ---------------
        print("\n!! simulating failure: restarting on half the islands "
              "from the last checkpoint (elastic)", flush=True)
        rows = launch_mesh.spawn(restart_ranks, N_ISLANDS // 2, args.device,
                                 (args.device, ckpt_dir))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"restored onto {len(rows)} ranks: {rows} rows a rank")
    print("elastic restart OK — search state survived the failure")


if __name__ == "__main__":
    main()
