"""The printed-MLP family: integer-weight MAC genes on the shared engine.

The counterpart of `repro.families.printed_mlp` (without its sweep
padding, which comes with the sweep's slice of the port):

  - **Master weights.** A bias-free one-hidden-layer ReLU MLP is trained by
    full-batch gradient descent from initial weights drawn with a
    `torch.Generator`, then each layer is quantized with ONE per-layer
    scale to 4-bit signed master codes in [-8, 7]. Without biases the
    network is positively homogeneous, so dropping the scales never moves
    the argmax: the hardware computes pure integer arithmetic on the 8-bit
    input codes.
  - **Genes.** Two per neuron (hidden and output): a precision gene (weight
    bits in [2, 4], a right shift of the master code) and a margin gene
    (snap window in [0, 5]) that snaps the truncated code to the cheapest
    popcount pattern through `quantize.bespoke.snap_lut`.
  - **Decode tables.** 3 x 6 = 18 (bits, margin) combos, so decoding is a
    gather: `tw1[combo, F, H]` / `tw2[combo, H, C]` hold every neuron's
    effective integer weights per combo and `cost1` / `cost2` their area
    in integer `AREA_QUANTUM_MM2` quanta.
  - **Exact arithmetic.** ``x8 @ W1`` sums integers below 255 * 8 * F <
    2^24, the ReLU output is floor-shifted by a static per-problem `shift`
    so that the second layer's sums stay below 2^24 too. The kernel backend
    runs the whole population's first layer as ONE `kernels.ops.qmatmul`
    launch (weights concatenated on the output axis) over the uint8 codes,
    int32 sums on the integer tensor cores, exact; the reference backend
    runs it as a float64 matmul. The
    second layer is a float64 product, exact and independent of
    `torch.backends.cuda.matmul.allow_tf32`. Argmax keeps the first
    maximum on ties.
  - **Objectives** (both minimised): the exact design's accuracy minus the
    chromosome's, with the accuracy rounded as the reference rounds it
    (float32 count / float32 rows, a true division), and the area as
    ``float32(units) / float32(exact_units)`` over integer quanta, as the
    port's tree family scores it; the exact design scores exactly (0, 1).
  - **Verify triangle.** `write_artifact(verify_rtl=True)` requires, per
    pareto point, netlist simulation (`core.netlist.build_mlp_circuit`) ==
    integer predict (`predict_master`) == the `qmatmul` kernel route.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.core import area as area_mod
from repro_torch.core import netlist
from repro_torch.device import resolve_device
from repro_torch.families.base import ClassifierFamily
from repro_torch.kernels.qmatmul import code_buffer
from repro_torch.quantize import bespoke

MASTER_WBITS = 4            # master weight codes are 4-bit signed: [-8, 7]
WB_MIN, WB_MAX = 2, 4       # precision gene range (truncations of the master)
N_MARGINS = 6               # margin gene range [0, 5], as for comparators
N_COMBOS = (WB_MAX - WB_MIN + 1) * N_MARGINS        # 18 decode table rows
EXACT_COMBO = (WB_MAX - WB_MIN) * N_MARGINS         # (bits=4, margin=0)
DEFAULT_HIDDEN = 16


# ---------------------------------------------------------------------------
# training + master quantization
# ---------------------------------------------------------------------------

def init_weights(generator: torch.Generator, n_features: int, n_hidden: int,
                 n_classes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Initial (w1 (F, H), w2 (H, C)) float32 on the generator's device:
    standard normal draws scaled by fan-in^-1/2, as `repro`'s `train_mlp`
    draws them from `jax.random` (which torch cannot replay)."""
    dev = generator.device
    w1 = torch.randn((n_features, n_hidden), generator=generator,
                     device=dev) * n_features ** -0.5
    w2 = torch.randn((n_hidden, n_classes), generator=generator,
                     device=dev) * n_hidden ** -0.5
    return w1, w2


def train_mlp(x_train, y_train, w1_init: torch.Tensor, w2_init: torch.Tensor,
              n_steps: int = 300, lr: float = 0.5):
    """Full-batch gradient descent on a bias-free one-hidden-layer ReLU MLP
    with mean cross-entropy, from the given initial weights, on their
    device. Returns float32 numpy (w1 (F, H), w2 (H, C))."""
    dev = w1_init.device
    x = torch.as_tensor(np.asarray(x_train, np.float32), device=dev)
    y = torch.as_tensor(np.asarray(y_train, np.int64), device=dev)
    w1 = w1_init.detach().to(torch.float32).clone().requires_grad_(True)
    w2 = w2_init.detach().to(torch.float32).clone().requires_grad_(True)
    for _ in range(n_steps):
        logits = torch.relu(x @ w1) @ w2
        loss = torch.nn.functional.cross_entropy(logits, y)
        g1, g2 = torch.autograd.grad(loss, (w1, w2))
        with torch.no_grad():
            w1 -= lr * g1
            w2 -= lr * g2
    return w1.detach().cpu().numpy(), w2.detach().cpu().numpy()


def quantize_master(w) -> np.ndarray:
    """Float layer -> 4-bit signed master codes with ONE per-layer scale
    (a per-channel scale would change relative neuron magnitudes)."""
    w = np.asarray(w, np.float64)
    scale = max(float(np.abs(w).max()), 1e-9) / ((1 << (MASTER_WBITS - 1)) - 1)
    lo, hi = -(1 << (MASTER_WBITS - 1)), (1 << (MASTER_WBITS - 1)) - 1
    return np.clip(np.round(w / scale), lo, hi).astype(np.int32)


def effective_weights(master: np.ndarray, bits, margin) -> np.ndarray:
    """Per-column decode: truncate master codes to `bits`, snap within
    `margin`, rescale back to the master grid. `bits` / `margin` run over
    the trailing (neuron) axis."""
    master = np.asarray(master, np.int32)
    bits = np.asarray(bits, np.int64)
    margin = np.asarray(margin, np.int64)
    out = np.zeros_like(master)
    for j in range(master.shape[1]):
        b, m = int(bits[j]), int(margin[j])
        sh = MASTER_WBITS - b
        code = master[:, j] >> sh          # arithmetic shift: round to floor
        lut = bespoke.snap_lut(b, m)
        out[:, j] = lut[code + (1 << (b - 1))] << sh
    return out


# ---------------------------------------------------------------------------
# accumulator widths + decode tables
# ---------------------------------------------------------------------------

def _max_abs_w() -> int:
    return 1 << (MASTER_WBITS - 1)


def acc1_bound(n_features: int) -> int:
    """Upper bound on a hidden accumulator (one sign of the (pos, neg) pair)."""
    return 255 * _max_abs_w() * n_features


def pick_shift(n_features: int, n_hidden: int) -> int:
    """Smallest static ReLU right shift keeping layer-2 sums below 2^24."""
    sh = 0
    while (acc1_bound(n_features) >> sh) * _max_abs_w() * n_hidden >= (1 << 24):
        sh += 1
    return sh


def _acc_widths(n_features: int, n_hidden: int,
                shift: int) -> tuple[int, int, int]:
    """(hidden act bits, hidden out bits, output act bits) for the area model."""
    a1 = max(1, acc1_bound(n_features).bit_length())
    hid = max(1, (acc1_bound(n_features) >> shift).bit_length())
    a2 = max(1, ((acc1_bound(n_features) >> shift)
                 * _max_abs_w() * n_hidden).bit_length())
    return a1, hid, a2


def combo_tables(w1_master: np.ndarray, w2_master: np.ndarray, shift: int):
    """(TW1, TW2, COST1, COST2) numpy: per-combo effective weights (18, F, H)
    / (18, H, C) int32 and area (18, H) / (18, C) int64 in quanta."""
    n_features, n_hidden = w1_master.shape
    n_classes = w2_master.shape[1]
    a1, hid, a2 = _acc_widths(n_features, n_hidden, shift)
    tw1 = np.zeros((N_COMBOS, n_features, n_hidden), np.int32)
    tw2 = np.zeros((N_COMBOS, n_hidden, n_classes), np.int32)
    cost1 = np.zeros((N_COMBOS, n_hidden), np.int64)
    cost2 = np.zeros((N_COMBOS, n_classes), np.int64)
    for b in range(WB_MIN, WB_MAX + 1):
        for m in range(N_MARGINS):
            k = (b - WB_MIN) * N_MARGINS + m
            tw1[k] = effective_weights(w1_master, np.full(n_hidden, b),
                                       np.full(n_hidden, m))
            tw2[k] = effective_weights(w2_master, np.full(n_classes, b),
                                       np.full(n_classes, m))
            cost1[k] = [area_mod.mlp_neuron_area_units(tw1[k][:, j], 8, a1)
                        for j in range(n_hidden)]
            cost2[k] = [area_mod.mlp_neuron_area_units(tw2[k][:, c], hid, a2)
                        for c in range(n_classes)]
    return tw1, tw2, cost1, cost2


# ---------------------------------------------------------------------------
# the problem
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MLPProblem:
    """One dataset bound to a trained master-code MLP.

    The masters and shift stay on the host (artifact, netlist, serving);
    the decode tables and the test split live on the problem's device."""

    w1_master: np.ndarray      # (F, H) int32 in [-8, 7]
    w2_master: np.ndarray      # (H, C) int32
    shift: int
    n_classes: int
    tw1: torch.Tensor          # (18, F, H) int8 effective weights
    tw2: torch.Tensor          # (18, H, C) float64 effective weights
    cost1: torch.Tensor        # (18, H) int64 area quanta
    cost2: torch.Tensor        # (18, C) int64
    x8: torch.Tensor           # (B, F) int32 master input codes
    x8u: torch.Tensor          # (B, F) uint8, the same codes, rows
                               # 16-byte aligned (`qmatmul.code_buffer`)
    y: torch.Tensor            # (B,) int64 labels
    exact_units: int           # exact design's area in quanta
    exact_accuracy: float

    @property
    def device(self) -> torch.device:
        return self.x8.device

    @property
    def n_features(self) -> int:
        return int(self.w1_master.shape[0])

    @property
    def n_hidden(self) -> int:
        return int(self.w1_master.shape[1])

    @property
    def n_units(self) -> int:
        return self.n_hidden + self.n_classes

    @property
    def n_genes(self) -> int:
        return 2 * self.n_units

    @property
    def exact_area_mm2(self) -> float:
        return self.exact_units * area_mod.AREA_QUANTUM_MM2

    def exact_genes(self) -> np.ndarray:
        return exact_genes(self.n_units)


def exact_genes(n_units: int) -> np.ndarray:
    """Chromosome decoding every neuron to (bits=4, margin=0): the master
    codes unchanged, the exact design."""
    g = np.zeros(2 * n_units, np.float32)
    g[0::2] = 0.999
    g[1::2] = 0.0
    return g


def predict_master(w1, w2, shift: int, x8) -> np.ndarray:
    """Integer tensor oracle (numpy int64): (B, F) codes -> (B,) classes."""
    h = np.asarray(x8, np.int64) @ np.asarray(w1, np.int64)
    hq = np.maximum(h, 0) >> shift
    s = hq @ np.asarray(w2, np.int64)
    return np.argmax(s, axis=1).astype(np.int32)


def _accuracy(correct: torch.Tensor, n: int) -> torch.Tensor:
    """float32 accuracy, rounded as the reference rounds it: a float32
    division of the count by the row count."""
    return correct.to(torch.float32) / torch.full(
        (), float(n), dtype=torch.float32, device=correct.device)


def problem_from_masters(w1_master, w2_master, shift: int, n_classes: int,
                         x8, y, device="cuda") -> MLPProblem:
    """The problem of given master codes on a test split: decode tables,
    the exact design's accuracy and area in quanta."""
    dev = resolve_device(device)
    w1m = np.asarray(w1_master, np.int32)
    w2m = np.asarray(w2_master, np.int32)
    x8 = np.asarray(x8, np.int32)
    y = np.asarray(y, np.int64)
    n_features, n_hidden = w1m.shape
    if w2m.shape != (n_hidden, n_classes) or x8.shape[1:] != (n_features,):
        raise ValueError(f"masters w1{w1m.shape} / w2{w2m.shape} do not fit "
                         f"{n_classes} classes and codes x8{x8.shape}")
    if x8.size and (x8.min() < 0 or x8.max() > 255):
        raise ValueError("input codes must lie in [0, 255]")
    lo, hi = -(1 << (MASTER_WBITS - 1)), (1 << (MASTER_WBITS - 1)) - 1
    if min(w1m.min(), w2m.min()) < lo or max(w1m.max(), w2m.max()) > hi:
        raise ValueError(f"master codes must lie in [{lo}, {hi}]")
    if acc1_bound(n_features) >= (1 << 24):
        raise ValueError(
            f"{n_features} features overflow the float32-exact hidden "
            f"accumulator bound (needs 255*8*F < 2^24)")
    tw1, tw2, cost1, cost2 = combo_tables(w1m, w2m, shift)
    pred = predict_master(w1m, w2m, shift, x8)
    exact_acc = float(np.float32((pred == y).sum()) / np.float32(x8.shape[0]))
    exact_units = int(cost1[EXACT_COMBO].sum() + cost2[EXACT_COMBO].sum())

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    return MLPProblem(
        w1_master=w1m, w2_master=w2m, shift=int(shift),
        n_classes=int(n_classes),
        tw1=t(tw1, torch.int8), tw2=t(tw2, torch.float64),
        cost1=t(cost1, torch.int64), cost2=t(cost2, torch.int64),
        x8=t(x8, torch.int32), x8u=code_buffer(t(x8, torch.uint8)),
        y=t(y, torch.int64),
        exact_units=exact_units, exact_accuracy=exact_acc)


def build_problem(dataset, n_hidden: int = DEFAULT_HIDDEN,
                  n_steps: int = 300, seed: int = 0,
                  device="cuda") -> MLPProblem:
    """Train + master-quantize the MLP for `dataset` (name or `Dataset`) on
    `device`; the initial weights come from a CPU `torch.Generator` seeded
    with `seed`, so they are the same on every device."""
    from repro_torch.datasets import load_dataset, quantize_u8

    dev = resolve_device(device)
    ds = load_dataset(dataset) if isinstance(dataset, str) else dataset
    n_features = ds.x_train.shape[1]
    gen = torch.Generator().manual_seed(seed)
    w1_init, w2_init = init_weights(gen, n_features, n_hidden, ds.n_classes)
    w1f, w2f = train_mlp(ds.x_train, ds.y_train, w1_init.to(dev),
                         w2_init.to(dev), n_steps=n_steps)
    return problem_from_masters(
        quantize_master(w1f), quantize_master(w2f),
        pick_shift(n_features, n_hidden), ds.n_classes,
        quantize_u8(ds.x_test), ds.y_test, device=dev)


# ---------------------------------------------------------------------------
# gene decode + fitness (reference and kernel backends)
# ---------------------------------------------------------------------------

def decode_combos(genes: torch.Tensor) -> torch.Tensor:
    """(..., 2U) float32 genes -> (..., U) int64 decode-table rows.

    Per unit: bits = WB_MIN + clip(floor(g_bits * 3), 0, 2) and margin =
    clip(floor(g_margin * 6), 0, 5), in float32 as the reference decodes."""
    span = WB_MAX - WB_MIN + 1
    genes = genes.to(torch.float32)
    gb, gm = genes[..., 0::2], genes[..., 1::2]
    bits = torch.clamp(torch.floor(gb * span), 0, span - 1)
    marg = torch.clamp(torch.floor(gm * N_MARGINS), 0, N_MARGINS - 1)
    return (bits * N_MARGINS + marg).to(torch.int64)


def decode_design(genes) -> tuple[np.ndarray, np.ndarray]:
    """Host decode: (2U,) genes -> (bits (U,), margin (U,)) int32 arrays."""
    combos = decode_combos(torch.as_tensor(np.asarray(genes, np.float32)))
    combos = combos.numpy()
    return ((WB_MIN + combos // N_MARGINS).astype(np.int32),
            (combos % N_MARGINS).astype(np.int32))


def _gather_layers(problem: MLPProblem, combos: torch.Tensor):
    """combos (P, H + C) -> (w1 (F, P, H) int8, w2 (P, H, C) float64,
    units (P,) int64): every chromosome's effective weights and area."""
    h, c = problem.n_hidden, problem.n_classes
    kh, ko = combos[:, :h], combos[:, h:]
    h_idx = torch.arange(h, device=combos.device)
    c_idx = torch.arange(c, device=combos.device)
    w1 = problem.tw1.permute(1, 0, 2)[:, kh, h_idx]          # (F, P, H)
    w2 = problem.tw2.permute(1, 0, 2)[:, ko, c_idx].permute(1, 0, 2)
    units = (problem.cost1[kh, h_idx].sum(-1)
             + problem.cost2[ko, c_idx].sum(-1))
    return w1, w2, units


def _predict(problem: MLPProblem, h: torch.Tensor,
             w2: torch.Tensor) -> torch.Tensor:
    """Hidden sums h (B, P, H) float32 -> (P, B) first-max argmax classes:
    ReLU, floor shift (a power of two, exact), then the second layer in
    float64 (exact: every sum is an integer below 2^24)."""
    hq = torch.floor(torch.clamp(h, min=0.0) * 2.0 ** -problem.shift)
    s = torch.einsum("bph,phc->pbc", hq.to(torch.float64), w2)
    return torch.argmax(s, dim=-1)


def _objectives(problem: MLPProblem, pred: torch.Tensor,
                units: torch.Tensor) -> torch.Tensor:
    """(P, B) classes + (P,) area quanta -> (P, 2) float32 objectives."""
    correct = (pred == problem.y[None, :]).sum(-1)
    acc = _accuracy(correct, problem.y.shape[0])
    loss = torch.full((), problem.exact_accuracy, dtype=torch.float32,
                      device=acc.device) - acc
    area = units.to(torch.float32) / float(problem.exact_units)
    return torch.stack([loss, area], dim=1)


def population_objectives(problem: MLPProblem,
                          pop: torch.Tensor) -> torch.Tensor:
    """Reference fitness: (P, 2U) -> (P, 2), the first layer as a plain
    float64 matmul."""
    combos = decode_combos(pop)
    w1, w2, units = _gather_layers(problem, combos)
    p = pop.shape[0]
    h = problem.x8u.to(torch.float64) @ w1.reshape(
        problem.n_features, p * problem.n_hidden).to(torch.float64)
    h = h.to(torch.float32).reshape(-1, p, problem.n_hidden)
    return _objectives(problem, _predict(problem, h, w2), units)


def make_reference_fitness(problem: MLPProblem):
    def fitness(pop):
        return population_objectives(problem, pop)

    return fitness


def make_kernel_fitness(problem: MLPProblem):
    """Kernel fitness: the population's first layer as ONE `qmatmul`
    launch, ``x8u (B, F) uint8 @ w (F, P*H) int8`` on the integer tensor
    cores, so the test split streams through the kernel once per
    generation. Equal to the reference."""
    from repro_torch.kernels import ops as kops

    def fitness(pop):
        combos = decode_combos(pop)
        w1, w2, units = _gather_layers(problem, combos)
        p = pop.shape[0]
        n = p * problem.n_hidden
        ones = torch.ones((n,), dtype=torch.float32, device=problem.device)
        h = kops.qmatmul(problem.x8u, w1.reshape(problem.n_features, n), ones)
        h = h.reshape(-1, p, problem.n_hidden)
        return _objectives(problem, _predict(problem, h, w2), units)

    return fitness


def make_kernel_predict(problem: MLPProblem):
    """One chromosome (2U,) -> (B,) classes through the `qmatmul` route:
    the kernel leg of the verify triangle."""
    from repro_torch.kernels import ops as kops

    ones = torch.ones((problem.n_hidden,), dtype=torch.float32,
                      device=problem.device)

    def predict(genes: torch.Tensor) -> torch.Tensor:
        w1, w2, _ = _gather_layers(problem, decode_combos(genes[None, :]))
        h = kops.qmatmul(problem.x8u, w1[:, 0, :], ones)
        return _predict(problem, h[:, None, :], w2)[0]

    return predict


# ---------------------------------------------------------------------------
# artifact schema (family-tagged pareto.json) + loader
# ---------------------------------------------------------------------------

MLP_REQUIRED_TOP_KEYS = frozenset({
    "family", "backend", "wall_s", "n_evaluations", "n_dispatches",
    "n_features", "n_hidden", "n_classes", "w1_master", "w2_master", "shift",
    "exact_accuracy", "exact_area_mm2", "rtl_verified", "pareto",
})
MLP_OPTIONAL_TOP_KEYS = frozenset({"dataset"})
MLP_REQUIRED_POINT_KEYS = frozenset({
    "acc_loss", "norm_area", "area_mm2", "area_netlist_mm2",
    "netlist_gates", "bits", "margin", "genes",
})
MLP_OPTIONAL_POINT_KEYS = frozenset({"rtl", "verified"})


def validate_payload(payload: dict, where: str = "payload") -> dict:
    """Two-way key-set + layout validation, as `search.artifact` does for
    trees; a mismatch raises a `ValueError` naming it."""
    from repro_torch.search.artifact import _check_keys

    if not isinstance(payload, dict):
        raise ValueError(f"pareto artifact {where}: expected a JSON object, "
                         f"got {type(payload).__name__}")
    _check_keys(payload, MLP_REQUIRED_TOP_KEYS, MLP_OPTIONAL_TOP_KEYS, where)
    if payload["family"] != "mlp":
        raise ValueError(f"pareto artifact {where}: family "
                         f"{payload['family']!r} is not 'mlp'")
    f, h, c = (payload["n_features"], payload["n_hidden"],
               payload["n_classes"])
    if len(payload["w1_master"]) != f or any(len(r) != h
                                             for r in payload["w1_master"]):
        raise ValueError(f"pareto artifact {where}: 'w1_master' must be "
                         f"{f} rows x {h} columns")
    if len(payload["w2_master"]) != h or any(len(r) != c
                                             for r in payload["w2_master"]):
        raise ValueError(f"pareto artifact {where}: 'w2_master' must be "
                         f"{h} rows x {c} columns")
    points = payload["pareto"]
    if not isinstance(points, list):
        raise ValueError(f"pareto artifact {where}: 'pareto' must be a list")
    for i, point in enumerate(points):
        if not isinstance(point, dict):
            raise ValueError(
                f"pareto artifact {where}: pareto[{i}] must be an object")
        _check_keys(point, MLP_REQUIRED_POINT_KEYS, MLP_OPTIONAL_POINT_KEYS,
                    f"{where}.pareto[{i}]")
        for key in ("bits", "margin"):
            if len(point[key]) != h + c:
                raise ValueError(
                    f"pareto artifact {where}: pareto[{i}].{key} has "
                    f"{len(point[key])} entries, expected {h + c} neurons")
    return payload


@dataclasses.dataclass
class MlpParetoArtifact:
    """A loaded, validated MLP `pareto.json`: master codes + pareto points.

    `point_design(i)` rebuilds point i's EFFECTIVE integer weights from the
    masters and the point's per-neuron (bits, margin) through the same snap
    tables the search decoded with, so serving a point reproduces its
    recorded accuracy exactly."""

    payload: dict
    w1_master: np.ndarray       # (F, H) int32
    w2_master: np.ndarray       # (H, C) int32
    shift: int
    n_features: int
    n_hidden: int
    n_classes: int
    exact_accuracy: float
    exact_area_mm2: float
    dataset: str | None
    points: list
    family: str = "mlp"

    def point_design(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(w1_eff (F, H), w2_eff (H, C)) int32 effective weights of point i."""
        point = self.points[i]
        bits = np.asarray(point["bits"], np.int64)
        margin = np.asarray(point["margin"], np.int64)
        h = self.n_hidden
        w1 = effective_weights(self.w1_master, bits[:h], margin[:h])
        w2 = effective_weights(self.w2_master, bits[h:], margin[h:])
        return w1, w2

    def point_accuracy(self, i: int) -> float:
        return self.exact_accuracy - float(self.points[i]["acc_loss"])

    def best_under_loss(self, max_loss: float = 0.01) -> int | None:
        ok = [i for i, p in enumerate(self.points)
              if p["acc_loss"] <= max_loss + 1e-9]
        if not ok:
            return None
        return min(ok, key=lambda i: self.points[i]["norm_area"])


def artifact_from_payload(payload: dict,
                          where: str = "payload") -> MlpParetoArtifact:
    validate_payload(payload, where)
    return MlpParetoArtifact(
        payload=payload,
        w1_master=np.asarray(payload["w1_master"], np.int32),
        w2_master=np.asarray(payload["w2_master"], np.int32),
        shift=int(payload["shift"]),
        n_features=int(payload["n_features"]),
        n_hidden=int(payload["n_hidden"]),
        n_classes=int(payload["n_classes"]),
        exact_accuracy=float(payload["exact_accuracy"]),
        exact_area_mm2=float(payload["exact_area_mm2"]),
        dataset=payload.get("dataset"),
        points=list(payload["pareto"]),
    )


def write_artifact(problem: MLPProblem, result, out_dir: str, *,
                   emit_rtl: bool = False, verify_rtl: bool = False,
                   dataset: str | None = None) -> str:
    """MLP `pareto.json`: masters + decoded designs + hardware artifact.

    Per point: the decoded per-neuron (bits, margin), the netlist's area and
    gate inventory, optional Verilog (`emit_rtl`, the gate dump of
    `core.rtl.emit_circuit_verilog`) and, under `verify_rtl`, the verify
    triangle over the whole test split: netlist simulation == integer
    predict == `qmatmul` kernel route."""
    from repro_torch.core import rtl

    os.makedirs(out_dir, exist_ok=True)
    if emit_rtl:
        os.makedirs(os.path.join(out_dir, "rtl"), exist_ok=True)
    kernel_predict = make_kernel_predict(problem) if verify_rtl else None
    x8 = problem.x8.cpu().numpy()

    points = []
    for i, (o, g) in enumerate(zip(result.pareto_objs, result.pareto_genes)):
        bits, margin = decode_design(g)
        h = problem.n_hidden
        w1 = effective_weights(problem.w1_master, bits[:h], margin[:h])
        w2 = effective_weights(problem.w2_master, bits[h:], margin[h:])
        circuit = netlist.build_mlp_circuit(w1, w2, problem.shift,
                                            problem.n_classes)
        point = {
            "acc_loss": float(o[0]),
            "norm_area": float(o[1]),
            "area_mm2": float(o[1] * problem.exact_area_mm2),
            "area_netlist_mm2": round(netlist.netlist_area_mm2(circuit), 4),
            "netlist_gates": netlist.gate_counts(circuit),
            "bits": bits.tolist(),
            "margin": margin.tolist(),
            "genes": np.asarray(g, np.float64).round(6).tolist(),
        }
        if emit_rtl:
            verilog = rtl.emit_circuit_verilog(circuit,
                                               module_name="printed_mlp")
            rel = os.path.join("rtl", f"point_{i:02d}.v")
            with open(os.path.join(out_dir, rel), "w") as fh:
                fh.write(verilog)
            point["rtl"] = rel
        if verify_rtl:
            sim = netlist.simulate(circuit, problem.x8).cpu().numpy()
            ref = predict_master(w1, w2, problem.shift, x8)
            ker = kernel_predict(torch.as_tensor(
                np.asarray(g, np.float32), device=problem.device))
            ker = ker.cpu().numpy()
            if not (np.array_equal(sim, ref) and np.array_equal(sim, ker)):
                n_ref = int((sim != ref).sum())
                n_ker = int((sim != ker).sum())
                raise AssertionError(
                    f"mlp pareto point {i}: netlist simulation diverges from "
                    f"the tensor predict on {n_ref} and from the kernel "
                    f"route on {n_ker} of {sim.shape[0]} test samples")
            point["verified"] = True
        points.append(point)

    payload = {
        "family": "mlp",
        "backend": result.backend,
        "wall_s": round(result.wall_s, 3),
        "n_evaluations": result.n_evaluations,
        "n_dispatches": result.n_dispatches,
        "n_features": problem.n_features,
        "n_hidden": problem.n_hidden,
        "n_classes": problem.n_classes,
        "w1_master": problem.w1_master.tolist(),
        "w2_master": problem.w2_master.tolist(),
        "shift": int(problem.shift),
        "exact_accuracy": problem.exact_accuracy,
        "exact_area_mm2": problem.exact_area_mm2,
        "rtl_verified": bool(verify_rtl),
        "pareto": points,
    }
    if dataset is not None:
        payload["dataset"] = dataset
    validate_payload(payload, where="mlp write_artifact")
    path = os.path.join(out_dir, "pareto.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(payload, fh, indent=1)
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# the family object
# ---------------------------------------------------------------------------

class PrintedMlpFamily(ClassifierFamily):
    """Integer-weight printed MLPs (arxiv 2402.02930 / 2312.17612 style)."""

    name = "mlp"

    def owns(self, problem) -> bool:
        return isinstance(problem, MLPProblem)

    def build_problem(self, dataset: str, n_hidden: int = DEFAULT_HIDDEN,
                      **opts):
        return build_problem(dataset, n_hidden=n_hidden, **opts)

    def n_genes(self, problem) -> int:
        return problem.n_genes

    def exact_genes(self, problem):
        return problem.exact_genes()

    def describe(self, problem) -> str:
        return (f"mlp: features={problem.n_features} "
                f"hidden={problem.n_hidden} classes={problem.n_classes} "
                f"shift={problem.shift} "
                f"exact_acc={problem.exact_accuracy:.3f}")

    def make_fitness(self, problem, backend: str = "reference"):
        if backend == "reference":
            return make_reference_fitness(problem)
        if backend == "kernel":
            return make_kernel_fitness(problem)
        raise ValueError(f"unknown fitness backend {backend!r} for the "
                         f"mlp family")

    def write_artifact(self, problem, result, out_dir: str, *,
                       emit_rtl: bool = False, verify_rtl: bool = False,
                       dataset: str | None = None) -> str:
        return write_artifact(problem, result, out_dir, emit_rtl=emit_rtl,
                              verify_rtl=verify_rtl, dataset=dataset)

    def load_artifact(self, payload_or_path):
        if isinstance(payload_or_path, str):
            with open(payload_or_path) as fh:
                payload = json.load(fh)
            return artifact_from_payload(payload, where=payload_or_path)
        return artifact_from_payload(payload_or_path)

    def make_server(self, artifact, point="best", max_loss: float = 0.01,
                    **opts):
        from repro_torch.runtime.classify import ClassifyServer
        return ClassifyServer.from_artifact(artifact, point=point,
                                            max_loss=max_loss, **opts)

    def build_point_circuit(self, artifact, idx: int):
        w1, w2 = artifact.point_design(idx)
        return netlist.build_mlp_circuit(w1, w2, artifact.shift,
                                         artifact.n_classes)


FAMILY = PrintedMlpFamily()
