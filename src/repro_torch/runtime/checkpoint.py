"""Checkpoints: atomic, retained, checked before a restore.

The counterpart of `repro.runtime.checkpoint`, in the same on-disk layout:
one ``ckpt_XXXXXXXX/`` directory per save holding ``arrays.npz`` (every
leaf) and ``manifest.json`` (step, keys, shapes, dtypes, ``"shards":
"full"`` and the producer's ``meta``). A save is written into a temporary
directory and renamed into place, the last ``keep`` saves are retained,
and `latest_step` skips a truncated archive or a corrupt manifest, so a
crash mid-write never breaks a resume.

Two forms. The search's `save` / `restore` keep a sequence of tensors and
arrays keyed by position (``"0"``, ``"1"``, ...). `save_tree` /
`restore_tree` keep a tree (a `runtime.train.TrainState`: params, optimizer
state, step) keyed by the JAX package's path strings ("0/embed",
"1/m/layers/attn/wq", "2"), so a checkpoint the JAX package wrote for the
same config restores into the port. A bfloat16 leaf is stored as the JAX
package stores one: its raw 2-byte words as a numpy ``V2`` array, the
manifest's dtype "bfloat16". A sharded state (a rank's blocks, with its
spec tree and mesh) is saved gathered, a leaf at a time, by one writer,
so it equals the unsharded state's checkpoint, and restores onto any
mesh, or none, by cutting each saved leaf (`restore_tree(..., specs=,
mesh=)`).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import warnings
import zipfile

import numpy as np
import torch

from repro_torch import pytree


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, leaves, keep: int = 3,
         meta: dict | None = None) -> str:
    """Write ``leaves`` (a sequence of tensors or arrays) as checkpoint
    ``step``; ``meta`` is JSON-serialisable producer metadata kept in the
    manifest (the search records its family, pop size and RNG there, so a
    resume with another layout fails with a clear error)."""
    items = ((str(i), arr, str(arr.dtype))
             for i, arr in enumerate(map(_as_numpy, leaves)))
    return _write(ckpt_dir, step, items, keep, meta)


def _tree_leaf(leaf) -> tuple[np.ndarray, str]:
    """(array to store, manifest dtype) of a tree leaf; bfloat16 as raw
    2-byte words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), \
                "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_tree(ckpt_dir: str, step: int, tree, keep: int = 3,
              meta: dict | None = None, specs=None, mesh=None) -> str:
    """Write every leaf of ``tree`` (dicts, sequences, dataclasses of
    tensors) as checkpoint ``step``, keyed by the JAX package's path
    strings.

    With ``specs`` (a spec tree like ``tree``, `sharding.params`) and
    ``mesh``, ``tree`` is a rank's blocks of a sharded state and every
    rank of the mesh must call this: each leaf is gathered whole, one leaf
    at a time, the writer (`launch.mesh.is_writer`) writes it and drops
    it, and the ranks meet at a barrier once the save is published. The
    checkpoint equals the unsharded state's, key for key and bit for
    bit."""
    from repro_torch.launch.mesh import barrier, is_writer

    writer = specs is None or is_writer()

    def items():
        for path, leaf in pytree.leaves_with_paths(tree):
            if specs is not None:
                from repro_torch.sharding.params import gather
                leaf = gather(leaf, pytree.get(specs, path), mesh)
            if writer:
                yield (pytree.path_str(path), *_tree_leaf(leaf))

    if not writer:
        for _ in items():
            pass
        barrier()
        return os.path.join(ckpt_dir, f"ckpt_{step:08d}")
    out = _write(ckpt_dir, step, items(), keep, meta)
    if specs is not None:
        barrier()
    return out


def restore_tree(ckpt_dir: str, step: int, like, specs=None, mesh=None):
    """(like, step): every leaf of ``like`` overwritten in place with the
    checkpoint's array of its path, cast to the leaf's dtype (a bfloat16
    array read from its raw words); the shapes must match. With ``specs``
    and ``mesh``, ``like`` is a rank's blocks and each leaf gets its block
    of the saved array (`sharding.params.shard`): the elastic restore, onto
    any mesh the layout divides over."""
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for p, leaf in pytree.leaves_with_paths(like):
            key = pytree.path_str(p)
            if key not in data:
                raise KeyError(f"checkpoint {path} has no leaf {key!r}")
            arr = data[key]
            if manifest["dtypes"].get(key) == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr))
            if specs is not None:
                from repro_torch.sharding.params import shard
                t = shard(t, pytree.get(specs, p), mesh)
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint {path} leaf {key!r} has shape "
                                 f"{tuple(t.shape)}, expected "
                                 f"{tuple(leaf.shape)}")
            with torch.no_grad():
                leaf.copy_(t.to(leaf.dtype))
    return like, manifest["step"]


def _write(ckpt_dir: str, step: int, items, keep: int,
           meta: dict | None) -> str:
    """Publish checkpoint ``step`` from ``items``, (key, array, manifest
    dtype) triples written into ``arrays.npz`` one at a time (numpy's
    own layout: one ``.npy`` member a key), then the manifest."""
    os.makedirs(ckpt_dir, exist_ok=True)
    shapes, dtypes = {}, {}
    final = os.path.join(ckpt_dir, f"ckpt_{step:08d}")
    with tempfile.TemporaryDirectory(dir=ckpt_dir) as tmp:
        with zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), "w",
                             allowZip64=True) as zf:
            for key, arr, dtype in items:
                with zf.open(key + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, np.asanyarray(arr),
                                              allow_pickle=False)
                shapes[key], dtypes[key] = list(arr.shape), dtype
        manifest = {
            "step": int(step),
            "keys": sorted(shapes),
            "shapes": shapes,
            "dtypes": dtypes,
            "shards": "full",
            "meta": meta or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        os.makedirs(final + ".tmp", exist_ok=True)
        for name in ("arrays.npz", "manifest.json"):
            os.replace(os.path.join(tmp, name),
                       os.path.join(final + ".tmp", name))
    os.replace(final + ".tmp", final)  # atomic publish
    _gc(ckpt_dir, keep)
    return final


def read_manifest(ckpt_dir: str, step: int) -> dict:
    """The JSON manifest of one checkpoint (with its ``meta`` dict)."""
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}", "manifest.json")
    with open(path) as f:
        return json.load(f)


def checkpoint_error(ckpt_dir: str, step: int) -> str | None:
    """Why ``ckpt_<step>`` cannot be restored, or None if it looks intact:
    the manifest must parse and carry its fields, and ``arrays.npz`` must
    open and decompress every member the manifest names, at its shape (a
    truncated write fails on read, not on open)."""
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        missing = [k for k in ("step", "keys", "shapes", "dtypes")
                   if k not in manifest]
        if missing:
            return f"manifest.json missing fields {missing}"
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for key in manifest["keys"]:
                arr = data[key]   # decompresses the member
                if list(arr.shape) != list(manifest["shapes"][key]):
                    return (f"arrays.npz[{key!r}] shape {list(arr.shape)} "
                            f"!= manifest {manifest['shapes'][key]}")
    except Exception as e:  # corrupt JSON, truncated zip, missing member...
        return f"{type(e).__name__}: {e}"
    return None


def latest_step(ckpt_dir: str) -> int | None:
    """The newest intact checkpoint step, or None: candidates are checked
    newest first with `checkpoint_error`, and broken ones are skipped with
    a warning."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted((int(m.group(1)) for d in os.listdir(ckpt_dir)
                    if (m := re.fullmatch(r"ckpt_(\d+)", d))), reverse=True)
    for step in steps:
        err = checkpoint_error(ckpt_dir, step)
        if err is None:
            return step
        warnings.warn(f"skipping unreadable checkpoint "
                      f"{ckpt_dir}/ckpt_{step:08d}: {err}")
    return None


def restore(ckpt_dir: str, step: int, like) -> tuple[list, int]:
    """(leaves, step): the saved leaves as tensors with the dtype and device
    of the matching leaf of ``like`` (a sequence of tensors), whose shapes
    they must have."""
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, leaf in enumerate(like):
            arr = data[str(i)]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"checkpoint {path} leaf {i} has shape {arr.shape}, "
                    f"expected {tuple(leaf.shape)}")
            out.append(torch.as_tensor(arr).to(dtype=leaf.dtype,
                                               device=leaf.device))
    return out, manifest["step"]


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(
        int(m.group(1)) for d in os.listdir(ckpt_dir)
        if (m := re.fullmatch(r"ckpt_(\d+)", d)))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"ckpt_{s:08d}"),
                      ignore_errors=True)
