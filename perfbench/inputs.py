"""The inputs of a configuration, made by its family and kept in a cache
inside the checkout.

A configuration's ``family`` names ``perfbench/families/<family>.py``,
whose ``make_inputs(config)`` makes them with the benchmark's own
reference (the dataset, and the trained tree or master codes). They are
the same for every seed: the seed draws the search and the campaigns,
never the problem. The cache file is named by a digest of the
configuration file, the family's file and every reference source, so an
edited trainer, family or configuration makes new inputs.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np


def family_file(config: dict, root: Path) -> Path:
    return root / "perfbench" / "families" / f"{config['family']}.py"


def cache_dir(root: Path) -> Path:
    return root / "build" / "perfbench" / "inputs"


def load(config_file: Path, family, root: Path) -> dict:
    """The configuration's inputs as numpy arrays, made by the loaded
    module ``family``."""
    text = config_file.read_bytes()
    config = json.loads(text)
    digest = hashlib.sha256(text)
    digest.update(family_file(config, root).read_bytes())
    for source in sorted((root / "perfbench" / "reference").glob("*.py")):
        digest.update(source.read_bytes())
    path = cache_dir(root) / f"{config['name']}-{digest.hexdigest()[:16]}.npz"
    if path.exists():
        with np.load(path) as saved:
            return {k: saved[k] for k in saved.files}
    made = family.make_inputs(config)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **made)
    os.replace(tmp, path)
    return made
