"""Layout of the mesh-sharded NSGA-II search state.

The counterpart of `repro.sharding.search`. One place says how an
`nsga2.NSGA2State` lays out over the search mesh, so `core.dist`, the
engine's checkpoint restore and the tests agree:

  - the population tensors (genes, objs, rank, crowd) split their
    population axis over the ``pop`` mesh axis: rank i of the axis holds
    rows [i * P/S, (i + 1) * P/S), what a gather in axis order rebuilds;
  - the generator and the generation counter are REPLICATED: every rank
    draws the same numbers, which is what makes the sharded generation's
    selection and variation equal the single-device step's
    (`core.dist._sharded_gen_body`);
  - the batched (sweep) layout adds a leading problem axis split over the
    ``bucket`` mesh axis, and the problems' generators follow it;
  - the islands layout splits the gathered island population over its
    ring axis, one island a rank, each with its own generator.

A spec gives, for each dimension of a tensor, the mesh axis it splits over
or None (the JAX package's `PartitionSpec`); the generator's spec is over
the list of generators.
"""
from __future__ import annotations

from repro_torch.core import nsga2

POP_FIELDS = ("genes", "objs", "rank", "crowd")


def search_state_specs(axis: str = "pop") -> dict:
    """Spec of each field of one sharded search state."""
    return {"genes": (axis, None), "objs": (axis, None), "rank": (axis,),
            "crowd": (axis,), "generator": (), "generation": ()}


def batched_state_specs(bucket_axis: str = "bucket",
                        axis: str = "pop") -> dict:
    """Spec of each field of a (problems, population) stacked state."""
    return {"genes": (bucket_axis, axis, None),
            "objs": (bucket_axis, axis, None),
            "rank": (bucket_axis, axis), "crowd": (bucket_axis, axis),
            "generator": (bucket_axis,), "generation": ()}


def island_state_specs(axis: str = "data") -> dict:
    """Spec of each field of the gathered islands state: island i's rows
    and generator on rank i of the ring."""
    return {"genes": (axis, None), "objs": (axis, None), "rank": (axis,),
            "crowd": (axis,), "generator": (axis,), "generation": ()}


def axis_extent(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def split(t, spec: tuple, mesh):
    """This rank's block of ``t`` (a tensor or a list) under ``spec``: each
    dimension named in the spec cut into equal blocks, in axis order."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, i = axis_extent(mesh, axis), mesh.get_local_rank(axis)
        size = len(t) if isinstance(t, list) else t.shape[dim]
        if size % n:
            raise ValueError(f"axis {dim} of size {size} not divisible by "
                             f"mesh axis {axis!r} ({n})")
        b = size // n
        if isinstance(t, list):
            t = t[i * b:(i + 1) * b]
        else:
            t = t.narrow(dim, i * b, b).contiguous()
    return t


def shard_state(state: nsga2.NSGA2State, mesh,
                specs: dict) -> nsga2.NSGA2State:
    """This rank's slab of a whole (gathered or restored) state."""
    return nsga2.NSGA2State(
        *(split(getattr(state, f), specs[f], mesh) for f in POP_FIELDS),
        state.generation)


def split_pop(state: nsga2.NSGA2State, mesh,
              specs: dict) -> nsga2.NSGA2State:
    """This rank's population slab of a state whose problem axis is split
    already (the sweep's block of problems, evaluated whole)."""
    pop_only = {f: tuple(None if a == specs["generator"][0] else a
                         for a in specs[f]) for f in POP_FIELDS}
    return shard_state(state, mesh, pop_only)
