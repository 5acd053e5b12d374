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
manifest's dtype "bfloat16".
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import warnings

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
    arrays = {str(i): _as_numpy(leaf) for i, leaf in enumerate(leaves)}
    return _write(ckpt_dir, step, arrays,
                  {k: str(v.dtype) for k, v in arrays.items()}, keep, meta)


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
              meta: dict | None = None) -> str:
    """Write every leaf of ``tree`` (dicts, sequences, dataclasses of
    tensors) as checkpoint ``step``, keyed by the JAX package's path
    strings."""
    arrays, dtypes = {}, {}
    for path, leaf in pytree.leaves_with_paths(tree):
        key = pytree.path_str(path)
        arrays[key], dtypes[key] = _tree_leaf(leaf)
    return _write(ckpt_dir, step, arrays, dtypes, keep, meta)


def restore_tree(ckpt_dir: str, step: int, like):
    """(like, step): every leaf of ``like`` overwritten in place with the
    checkpoint's array of its path, cast to the leaf's dtype (a bfloat16
    array read from its raw words); the shapes must match."""
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
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint {path} leaf {key!r} has shape "
                                 f"{tuple(t.shape)}, expected "
                                 f"{tuple(leaf.shape)}")
            with torch.no_grad():
                leaf.copy_(t.to(leaf.dtype))
    return like, manifest["step"]


def _write(ckpt_dir: str, step: int, arrays: dict, dtypes: dict, keep: int,
           meta: dict | None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    manifest = {
        "step": int(step),
        "keys": sorted(arrays.keys()),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": dtypes,
        "shards": "full",
        "meta": meta or {},
    }
    final = os.path.join(ckpt_dir, f"ckpt_{step:08d}")
    with tempfile.TemporaryDirectory(dir=ckpt_dir) as tmp:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
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
