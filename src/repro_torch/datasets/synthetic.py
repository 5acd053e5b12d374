"""Synthetic stand-ins for the paper's 10 UCI classification datasets.

A numpy copy of `repro.datasets.synthetic`: the PyTorch port keeps its own
copy so it never imports the JAX package, and the parity tests hold the two
copies to identical arrays for every spec.

Each generator is deterministic (fixed seed derived from the dataset name) and
matches the UCI dataset's (n_samples, n_features, n_classes) signature plus a
coarse notion of its feature discreteness (Balance/Mammographic are small-
integer-valued in UCI, which is what makes their bespoke comparators cheap in
the paper's Table I).

Data is a mixture of class-conditional Gaussian clusters over an informative
subspace, plus label noise to emulate each dataset's intrinsic difficulty
(paper Table I accuracies span 0.56..0.97).
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_samples: int
    n_features: int
    n_classes: int
    n_informative: int          # features that actually carry signal
    clusters_per_class: int = 1
    class_sep: float = 1.0      # separation of cluster centers (in sigma units)
    label_noise: float = 0.0    # fraction of labels re-drawn uniformly
    integer_levels: int | None = None  # quantize features to k levels (UCI-like)
    paper_accuracy: float = 0.0  # paper Table I DT accuracy, for reference


# Signatures follow the UCI originals; class_sep / label_noise are tuned so a
# fully-grown CART lands in the neighbourhood of the paper's Table I accuracy.
# class_sep / label_noise grid-tuned (benchmarks) so a fully-grown CART's
# test accuracy lands near the paper's Table I per-dataset accuracy.
DATASET_SPECS: dict[str, DatasetSpec] = {
    "arrhythmia": DatasetSpec("arrhythmia", 452, 279, 13, 24, 1, 2.6, 0.10, None, 0.564),
    "balance": DatasetSpec("balance", 625, 4, 3, 4, 2, 2.4, 0.05, 5, 0.745),
    "cardio": DatasetSpec("cardio", 2126, 21, 3, 10, 2, 2.6, 0.015, None, 0.928),
    "har": DatasetSpec("har", 10299, 561, 6, 40, 2, 3.2, 0.08, None, 0.835),
    "mammographic": DatasetSpec("mammographic", 961, 5, 2, 4, 1, 2.6, 0.10, 6, 0.759),
    "pendigits": DatasetSpec("pendigits", 10992, 16, 10, 14, 2, 4.2, 0.001, None, 0.968),
    "redwine": DatasetSpec("redwine", 1599, 11, 6, 8, 1, 2.8, 0.22, None, 0.600),
    "seeds": DatasetSpec("seeds", 210, 7, 3, 6, 1, 2.4, 0.02, None, 0.889),
    "vertebral": DatasetSpec("vertebral", 310, 6, 3, 5, 1, 2.2, 0.04, None, 0.850),
    "whitewine": DatasetSpec("whitewine", 4898, 11, 7, 8, 1, 3.0, 0.20, None, 0.617),
}


@dataclasses.dataclass
class Dataset:
    name: str
    x_train: np.ndarray  # float32 in [0, 1]
    y_train: np.ndarray  # int32
    x_test: np.ndarray
    y_test: np.ndarray
    n_classes: int

    @property
    def n_features(self) -> int:
        return self.x_train.shape[1]


def _seed_for(name: str) -> int:
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")


def _generate(spec: DatasetSpec) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(_seed_for(spec.name))
    n, d, c = spec.n_samples, spec.n_features, spec.n_classes
    n_inf = min(spec.n_informative, d)

    # cluster centers for every (class, cluster) on the informative subspace
    centers = rng.uniform(-1.0, 1.0, size=(c, spec.clusters_per_class, n_inf))
    centers *= spec.class_sep

    y = rng.integers(0, c, size=n).astype(np.int32)
    which = rng.integers(0, spec.clusters_per_class, size=n)
    x = rng.normal(0.0, 1.0, size=(n, d)).astype(np.float64)
    x[:, :n_inf] += centers[y, which]

    # a random rotation inside the informative block makes single-feature
    # splits non-trivial (like real tabular data)
    q, _ = np.linalg.qr(rng.normal(size=(n_inf, n_inf)))
    x[:, :n_inf] = x[:, :n_inf] @ q

    noise_mask = rng.random(n) < spec.label_noise
    y[noise_mask] = rng.integers(0, c, size=int(noise_mask.sum()))

    if spec.integer_levels is not None:
        # emulate small-integer UCI features (Balance: 1..5, Mammographic bins)
        lo, hi = np.percentile(x, [1, 99], axis=0)
        x = np.clip((x - lo) / np.maximum(hi - lo, 1e-9), 0.0, 1.0)
        k = spec.integer_levels
        x = np.round(x * (k - 1)) / (k - 1)
    return x.astype(np.float32), y


def train_test_split(
    x: np.ndarray, y: np.ndarray, test_fraction: float = 0.3, seed: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Random split; paper uses a random 30% test split."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    perm = rng.permutation(n)
    n_test = int(round(n * test_fraction))
    te, tr = perm[:n_test], perm[n_test:]
    return x[tr], y[tr], x[te], y[te]


def _normalize01(x_train: np.ndarray, x_test: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Min-max normalize to [0, 1] using *train* statistics (paper §IV)."""
    lo = x_train.min(axis=0)
    hi = x_train.max(axis=0)
    span = np.maximum(hi - lo, 1e-9)
    xt = np.clip((x_train - lo) / span, 0.0, 1.0)
    xe = np.clip((x_test - lo) / span, 0.0, 1.0)
    return xt.astype(np.float32), xe.astype(np.float32)


def quantize_u8(x: np.ndarray, bits: int = 8) -> np.ndarray:
    """Master fixed-point grid: x in [0,1] -> integer in [0, 2^bits - 1].

    floor-based truncation; 1.0 maps to the top code. All lower precisions are
    right-shifts of this master code (see core.quant).
    """
    scale = float(1 << bits)
    xi = np.floor(x * scale).astype(np.int64)
    return np.clip(xi, 0, (1 << bits) - 1).astype(np.uint8)


def load_dataset(name: str, test_fraction: float = 0.3, seed: int = 0) -> Dataset:
    spec = DATASET_SPECS[name]
    x, y = _generate(spec)
    xtr, ytr, xte, yte = train_test_split(x, y, test_fraction, seed)
    xtr, xte = _normalize01(xtr, xte)
    return Dataset(name, xtr, ytr, xte, yte, spec.n_classes)
