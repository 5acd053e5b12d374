"""Meshes of `torch.distributed` ranks: the search mesh, the production
and host meshes of LM training, and the rank launcher.

The counterpart of `repro.launch.mesh`: `make_search_mesh`, and
`make_production_mesh` (16x16 ``("data", "model")``, or 2x16x16 with
``"pod"``), `rules_for` and `make_host_mesh` for the sharded train step. Where the JAX
package lays a `shard_map` over the devices of one process, the port runs
one process per shard: each rank of a process group computes its slab on
its own device and the collectives of `core.dist` join them. A mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the group's ranks, with the
same axis names: ``("pop",)`` for a sharded search, ``("bucket", "pop")``
for the sweep, ``("data",)`` for the islands ring; each axis's collectives
run on ``mesh.get_group(axis)``.

Ranks come from one of three places (`run_ranks`):

- a group that already exists (the caller's, or torchrun's: ``WORLD_SIZE``
  set, rendezvous through ``env://``), which the mesh joins;
- `spawn`, which starts the ranks itself with the ``spawn`` start method
  (CUDA forbids ``fork`` after it is initialised) and a ``file://`` store
  in a temporary directory, so no network is needed, and returns each
  rank's return value; an exception in any rank raises in the caller;
- for a mesh of one rank, a group of one in this process.

Rank r computes on ``cuda:{r % torch.cuda.device_count()}``, or on the CPU
when the caller asks for it. The transport (`collective_backend`) is NCCL
when every rank has a card of its own and gloo when ranks share a card or
run on the CPU (NCCL refuses two ranks on one GPU); that is a choice of
transport only: every fitness, sort and kernel still runs on the rank's
device.
"""
from __future__ import annotations

import dataclasses
import math
import os
import pickle
import tempfile

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def auto_extent(device_type: str) -> int:
    """What ``"auto"`` means: the number of cards, or 1 on the CPU."""
    return torch.cuda.device_count() if device_type == "cuda" else 1


def mesh_shape(spec: str | None, axes=("pop",),
               device_type: str = "cuda") -> tuple[int, ...] | None:
    """The extents a ``--mesh`` spec asks for, one per axis (innermost
    last), or None for the single-device path.

      - None / "" / "none" -> None;
      - "auto"             -> `auto_extent` on the LAST axis (leading axes
                              get extent 1);
      - "4"                -> 4 ranks on the last axis;
      - "2x4"              -> one extent per axis (len must match ``axes``).
    """
    if spec is None or spec in ("", "none"):
        return None
    if spec == "auto":
        return (1,) * (len(axes) - 1) + (auto_extent(device_type),)
    try:
        dims = tuple(int(s) for s in spec.lower().split("x"))
    except ValueError:
        raise ValueError(
            f"bad mesh spec {spec!r}: want 'auto', 'N' or 'KxN'")
    if any(d < 1 for d in dims):
        raise ValueError(f"bad mesh spec {spec!r}: extents must be >= 1")
    if len(dims) == 1 and len(axes) > 1:
        dims = (1,) * (len(axes) - 1) + dims
    if len(dims) != len(axes):
        raise ValueError(
            f"mesh spec {spec!r} has {len(dims)} extents for "
            f"{len(axes)} axes {axes}")
    return dims


def mesh_size(spec: str | None, axes=("pop",),
              device_type: str = "cuda") -> int:
    """Ranks the spec needs (1 for the single-device path)."""
    shape = mesh_shape(spec, axes, device_type)
    return math.prod(shape) if shape else 1


def collective_backend(device_type: str, world_size: int,
                       n_cards: int) -> str:
    """``"nccl"`` when every rank has a card of its own, else ``"gloo"``
    (ranks sharing a card, or on the CPU)."""
    if device_type == "cuda" and world_size <= n_cards:
        return "nccl"
    return "gloo"


def rank_device(device="cuda", rank: int | None = None) -> torch.device:
    """The device rank ``rank`` (default: this process's rank, 0 without a
    group) computes on: ``cuda:{rank % device_count}`` for an unindexed
    CUDA request, else the request itself. Raises if CUDA is asked for and
    absent."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


_SINGLE = []   # the group of one this module made, if any


def _init_single(device_type: str) -> None:
    """A process group of one rank, in this process."""
    backend = collective_backend(device_type, 1, auto_extent(device_type))
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    _SINGLE.append(dist.group.WORLD)


def _in_group() -> bool:
    """True in a rank of a group other than the group of one made here."""
    return dist.is_initialized() and dist.group.WORLD not in _SINGLE


def make_search_mesh(spec: str | None = None, axes=("pop",),
                     device="cuda"):
    """The one search-mesh constructor behind every ``--mesh`` knob, as in
    the JAX package: engine, sweep and islands all route through here.

    ``spec`` follows `mesh_shape`'s grammar; ``axes`` names the mesh axes.
    Returns a `DeviceMesh` over the process group's ranks, or None for the
    single-device path. The group's world size must equal the product of
    the extents; a mesh of one rank makes a group of one if none exists.
    Every rank of the group must call this, in the same order (a 2-D mesh
    makes one subgroup per axis)."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = resolve_device(device).type
    shape = mesh_shape(spec, axes, device_type)
    if shape is None:
        return None
    n = math.prod(shape)
    if not dist.is_initialized() and n == 1:
        _init_single(device_type)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(
            f"mesh spec {spec!r} needs {n} devices, the process group has "
            f"{world} rank(s): one rank a device (start them with `python "
            f"-m repro_torch.search --mesh`, torchrun or "
            f"repro_torch.launch.mesh.spawn)")
    if device_type == "cuda":
        torch.cuda.set_device(rank_device("cuda"))
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axes))


PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _device_mesh(shape: tuple, axes: tuple, device):
    """A `DeviceMesh` of ``shape`` named ``axes`` over the first ranks of
    the process group (a group of one made here if none exists and one
    rank will do); raises `ValueError` when the group is too small."""
    from torch.distributed.device_mesh import DeviceMesh

    device_type = resolve_device(device).type
    n = math.prod(shape)
    if not dist.is_initialized() and n == 1:
        _init_single(device_type)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n > world:
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh {axes} needs {n} ranks, the "
            f"process group has {world}: one rank a device (start them with "
            f"torchrun or repro_torch.launch.mesh.spawn)")
    if device_type == "cuda":
        torch.cuda.set_device(rank_device("cuda"))
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production mesh: (data=16, model=16) on 256 ranks, or (pod=2,
    data=16, model=16) on 512, over the process group that exists (one
    rank a card, torchrun's). Raises `ValueError` naming both counts on a
    group of any other size, as `jax.make_mesh` fails without the
    devices."""
    shape, axes = PRODUCTION[multi_pod]
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(
            f"the production mesh {'x'.join(map(str, shape))} {axes} needs "
            f"{n} ranks, the process group has {world}")
    return _device_mesh(shape, axes, device)


def rules_for(mesh):
    """`RULES_3D` on a mesh with a ``pod`` axis, else `RULES_2D`, bound to
    ``mesh``, with ``tp`` the mesh's model-axis size (16 on the production
    meshes, as the JAX package's rules have it on any mesh)."""
    from repro_torch.sharding.rules import RULES_2D, RULES_3D, mesh_axes

    sizes = mesh_axes(mesh)
    base = RULES_3D if "pod" in sizes else RULES_2D
    return dataclasses.replace(base, tp=sizes.get("model", 1), mesh=mesh)


def make_host_mesh(n: int | None = None, axes=("data",), device="cuda"):
    """A small mesh for tests and examples on the group's ranks: ``n``
    (default: the group's size) ranks on one axis, or ``n // len(axes)``
    on each of several (the JAX package's rule)."""
    if n is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
    per = n // len(axes) if len(axes) > 1 else n
    shape = tuple([per] * len(axes)) if len(axes) > 1 else (n,)
    return _device_mesh(shape, tuple(axes), device)


def _rank_main(rank: int, world_size: int, backend: str, device_type: str,
               tmp: str, fn, args) -> None:
    """One spawned rank: join the group, run ``fn(*args)``, keep its
    return value for the parent. The host's cores are shared out among
    the ranks, so their CPU work does not oversubscribe them."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            world_size=world_size, rank=rank)
    try:
        out = fn(*args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, device="cuda", args=()) -> list:
    """Run ``fn(*args)`` on ``world_size`` new ranks (processes started
    with the ``spawn`` start method) and return each rank's return value,
    in rank order. ``fn`` must be importable by name (a module-level
    function) and its return value picklable. An exception in any rank
    stops the others and raises here (`torch.multiprocessing`'s
    ``ProcessRaisedException``)."""
    import torch.multiprocessing as mp

    device_type = resolve_device(device).type
    backend = collective_backend(device_type, world_size,
                                 auto_extent(device_type))
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        mp.start_processes(_rank_main,
                           args=(world_size, backend, device_type, tmp, fn,
                                 tuple(args)),
                           nprocs=world_size, join=True,
                           start_method="spawn")
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def join_group(device="cuda") -> None:
    """Join torchrun's process group (``WORLD_SIZE`` set, rendezvous
    through ``env://``) if this process is a rank of one and has not
    joined yet; nothing otherwise."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    device_type = resolve_device(device).type
    world = int(os.environ["WORLD_SIZE"])
    backend = collective_backend(device_type, world,
                                 auto_extent(device_type))
    if device_type == "cuda":
        torch.cuda.set_device(rank_device("cuda", int(os.environ.get(
            "LOCAL_RANK", os.environ.get("RANK", 0)))))
    dist.init_process_group(backend, init_method="env://")


def run_ranks(fn, world_size: int, device="cuda", args=()):
    """Run ``fn(*args)`` on every rank of a ``world_size`` group: in this
    process when it is a rank of such a group already (torchrun's
    ``WORLD_SIZE`` makes one through ``env://``) or when one rank will
    do, else on ranks started by `spawn`. Returns this process's result
    (rank 0's when spawned)."""
    join_group(device)
    if _in_group():
        if dist.get_world_size() != world_size:
            raise ValueError(
                f"this run needs {world_size} ranks, the process group has "
                f"{dist.get_world_size()}")
        return fn(*args)
    if world_size == 1:
        return fn(*args)
    return spawn(fn, world_size, device, args)[0]


def is_writer() -> bool:
    """True on the rank that writes artifacts and checkpoints: rank 0, or
    the only process without a group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the group (nothing without one)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
