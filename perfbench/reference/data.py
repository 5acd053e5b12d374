"""The benchmark's frozen copy of the seeded stand-ins for the paper's UCI
datasets, in numpy.

Each dataset is a mixture of class-conditional Gaussian clusters over an
informative subspace, rotated inside it, with label noise; the generator
is seeded from the dataset's name, so a name always gives the same arrays.
The split is a random 30% test split, min-max normalised to [0, 1] with
the training split's statistics; `quantize_u8` gives the 8-bit master
codes every comparator reads.

This copy is the yardstick's: the benchmark makes every input from it and
hands the same arrays to the program and to the plain reference.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class Spec:
    n_samples: int
    n_features: int
    n_classes: int
    n_informative: int
    clusters_per_class: int
    class_sep: float
    label_noise: float
    integer_levels: int | None


# (samples, features, classes) follow the UCI originals
SPECS = {
    "arrhythmia": Spec(452, 279, 13, 24, 1, 2.6, 0.10, None),
    "balance": Spec(625, 4, 3, 4, 2, 2.4, 0.05, 5),
    "cardio": Spec(2126, 21, 3, 10, 2, 2.6, 0.015, None),
    "har": Spec(10299, 561, 6, 40, 2, 3.2, 0.08, None),
    "mammographic": Spec(961, 5, 2, 4, 1, 2.6, 0.10, 6),
    "pendigits": Spec(10992, 16, 10, 14, 2, 4.2, 0.001, None),
    "redwine": Spec(1599, 11, 6, 8, 1, 2.8, 0.22, None),
    "seeds": Spec(210, 7, 3, 6, 1, 2.4, 0.02, None),
    "vertebral": Spec(310, 6, 3, 5, 1, 2.2, 0.04, None),
    "whitewine": Spec(4898, 11, 7, 8, 1, 3.0, 0.20, None),
}


def _generate(name: str) -> tuple[np.ndarray, np.ndarray]:
    spec = SPECS[name]
    seed = int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")
    rng = np.random.default_rng(seed)
    n, d, c = spec.n_samples, spec.n_features, spec.n_classes
    n_inf = min(spec.n_informative, d)
    centers = rng.uniform(-1.0, 1.0, size=(c, spec.clusters_per_class, n_inf))
    centers *= spec.class_sep
    y = rng.integers(0, c, size=n).astype(np.int32)
    which = rng.integers(0, spec.clusters_per_class, size=n)
    x = rng.normal(0.0, 1.0, size=(n, d)).astype(np.float64)
    x[:, :n_inf] += centers[y, which]
    q, _ = np.linalg.qr(rng.normal(size=(n_inf, n_inf)))
    x[:, :n_inf] = x[:, :n_inf] @ q
    noisy = rng.random(n) < spec.label_noise
    y[noisy] = rng.integers(0, c, size=int(noisy.sum()))
    if spec.integer_levels is not None:
        lo, hi = np.percentile(x, [1, 99], axis=0)
        x = np.clip((x - lo) / np.maximum(hi - lo, 1e-9), 0.0, 1.0)
        k = spec.integer_levels
        x = np.round(x * (k - 1)) / (k - 1)
    return x.astype(np.float32), y


def quantize_u8(x: np.ndarray) -> np.ndarray:
    """[0, 1] reals -> uint8 master codes, floor(x * 256) clipped to 255."""
    return np.clip(np.floor(x * 256.0).astype(np.int64), 0, 255).astype(
        np.uint8)


def load(name: str, test_fraction: float = 0.3, split_seed: int = 0) -> dict:
    """x_train, y_train, x_test, y_test (float32 in [0, 1], int32) and
    n_classes of dataset ``name``."""
    x, y = _generate(name)
    perm = np.random.default_rng(split_seed).permutation(x.shape[0])
    n_test = int(round(x.shape[0] * test_fraction))
    te, tr = perm[:n_test], perm[n_test:]
    x_tr, x_te = x[tr], x[te]
    lo, hi = x_tr.min(axis=0), x_tr.max(axis=0)
    span = np.maximum(hi - lo, 1e-9)
    return {
        "x_train": np.clip((x_tr - lo) / span, 0.0, 1.0).astype(np.float32),
        "y_train": y[tr],
        "x_test": np.clip((x_te - lo) / span, 0.0, 1.0).astype(np.float32),
        "y_test": y[te],
        "n_classes": SPECS[name].n_classes,
    }
