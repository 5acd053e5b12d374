"""The printed MLP: the benchmark's frozen trainer, its 4-bit master codes
and the per-neuron decode of a chromosome.

A bias-free one-hidden-layer ReLU MLP is trained by full-batch gradient
descent (mean cross-entropy, plain float32 PyTorch on the CPU) from
normal draws scaled by fan-in^-1/2 of a CPU generator seeded with the
configuration's seed. Each hidden neuron's input weights are kept summing
to zero (the draws and every step centred over the inputs), so the layer
sees its all-positive inputs as if centred: without a bias, a free layer
drives every neuron below zero on every row within a few steps and the
model sits at chance. Each layer is then quantised with one scale to codes
in [-8, 7]. The circuit computes pure integers on the 8-bit input codes:
h = x8 @ W1, ReLU, a static right shift that keeps layer-2 sums below
2^24, s = h' @ W2, the first maximum wins.

A chromosome has two genes per neuron (hidden, then output): the weight
precision b in [2, 4] (the master code shifted right by 4 - b, then back)
and a snap margin m in [0, 5]: each truncated code moves within +/-m to the
code of fewest set bits, ties to the smallest move, chased to a fixpoint.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import area

MASTER_BITS = 4
N_MARGINS = 6


def train_masters(x_train, y_train, n_classes: int, n_hidden: int,
                  n_steps: int, lr: float, seed: int):
    """(w1 (F, H), w2 (H, C)) int32 master codes."""
    return tuple(_master(w) for w in train_float(
        x_train, y_train, n_classes, n_hidden, n_steps, lr, seed))


def train_float(x_train, y_train, n_classes: int, n_hidden: int,
                n_steps: int, lr: float, seed: int):
    """(w1 (F, H), w2 (H, C)) float32 weights, trained as the module says."""
    n_features = x_train.shape[1]
    gen = torch.Generator().manual_seed(seed)
    w1 = torch.randn((n_features, n_hidden), generator=gen) * n_features ** -0.5
    w2 = torch.randn((n_hidden, n_classes), generator=gen) * n_hidden ** -0.5
    w1 -= w1.mean(0)
    x = torch.as_tensor(np.asarray(x_train, np.float32))
    y = torch.as_tensor(np.asarray(y_train, np.int64))
    w1.requires_grad_(True)
    w2.requires_grad_(True)
    for _ in range(n_steps):
        loss = torch.nn.functional.cross_entropy(torch.relu(x @ w1) @ w2, y)
        g1, g2 = torch.autograd.grad(loss, (w1, w2))
        with torch.no_grad():
            w1 -= lr * (g1 - g1.mean(0))
            w2 -= lr * g2
    return w1.detach().numpy(), w2.detach().numpy()


def _master(w) -> np.ndarray:
    w = np.asarray(w, np.float64)
    scale = max(float(np.abs(w).max()), 1e-9) / 7
    return np.clip(np.round(w / scale), -8, 7).astype(np.int32)


def shift_for(n_features: int, n_hidden: int) -> int:
    """Smallest ReLU right shift keeping layer-2 sums below 2^24."""
    bound = 255 * 8 * n_features
    sh = 0
    while (bound >> sh) * 8 * n_hidden >= 1 << 24:
        sh += 1
    return sh


def snap_table(bits: int, margin: int) -> np.ndarray:
    """code + 2^(bits-1) -> snapped code, for codes in [-2^(b-1), 2^(b-1))."""
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1

    out = {}
    for code in range(lo, hi + 1):
        cands = [code + d for d in range(-margin, margin + 1)
                 if lo <= code + d <= hi]
        # fewest set bits, then the smallest move, then the lower code
        out[code] = min(cands, key=lambda c: (bin(abs(c)).count("1"),
                                              abs(c - code)))
    for code in out:
        while out[out[code]] != out[code]:
            out[code] = out[out[code]]
    return np.asarray([out[c] for c in range(lo, hi + 1)], np.int64)


def decode_tables(w1: np.ndarray, w2: np.ndarray, shift: int):
    """For every (bits, margin) row k = (bits - 2) * 6 + margin: the
    effective weights eff1 (18, F, H), eff2 (18, H, C) int64 and the
    neurons' areas cost1 (18, H), cost2 (18, C) in quanta."""
    n_features, n_hidden = w1.shape
    bound = 255 * 8 * n_features
    acc1 = bound.bit_length()
    hid = (bound >> shift).bit_length()
    acc2 = ((bound >> shift) * 8 * n_hidden).bit_length()
    n_rows = 3 * N_MARGINS
    eff1 = np.zeros((n_rows, *w1.shape), np.int64)
    eff2 = np.zeros((n_rows, *w2.shape), np.int64)
    cost1 = np.zeros((n_rows, w1.shape[1]), np.int64)
    cost2 = np.zeros((n_rows, w2.shape[1]), np.int64)
    for bits in range(2, 5):
        sh = MASTER_BITS - bits
        for margin in range(N_MARGINS):
            k = (bits - 2) * N_MARGINS + margin
            lut = snap_table(bits, margin)
            for w, eff in ((w1, eff1), (w2, eff2)):
                eff[k] = lut[(w.astype(np.int64) >> sh) + (1 << (bits - 1))] << sh
            cost1[k] = [area.neuron_units(eff1[k][:, j], 8, acc1)
                        for j in range(w1.shape[1])]
            cost2[k] = [area.neuron_units(eff2[k][:, c], hid, acc2)
                        for c in range(w2.shape[1])]
    return eff1, eff2, cost1, cost2


EXACT_ROW = 2 * N_MARGINS   # bits 4, margin 0: the master codes unchanged
