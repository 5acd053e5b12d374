"""Classifier serving runtime for one searched design.

The counterpart of `repro.runtime.classify` for trees, forests and printed
MLPs. `ClassifyServer` loads one design (a `pareto.json` point of either
family, decoded tree or forest `bits`/`t_int` arrays, or an MLP's
effective integer weights through `ClassifyServer.for_mlp`) and serves
feature-vector requests:

  - a request of n rows pads up to the power-of-two bucket
    ``round_up_pow2(n)`` (at least GRANULE, at most ``max_batch``; larger
    requests split into ``max_batch`` chunks); padding rows are inert, as
    every row is classified independently, and are cropped on return;
  - each bucket keeps two static device buffer pairs (input codes,
    predictions) used alternately, allocated on the bucket's first request
    and reused afterwards, so steady-state serving allocates no buffers of
    its own;
  - featurize -> batch -> classify: `featurize` quantizes float features to
    the master 8-bit grid, `batch` pads codes to bucket shape, and the
    classify step runs the design's kernel (backend "kernel":
    `tree_infer_scores` for a tree, `qmatmul` for an MLP's first layer) or
    the plain PyTorch dataflow (backend "reference", on any device). The
    MLP's second layer is a float64 product either way, exact for its
    integer operands whatever the TF32 setting.

Integer inputs are sanitized with a mask (``codes & 0xFF``), not a clip:
the netlist reads input bits 0..7, so out-of-grid integers wrap mod 256 in
hardware and the server agrees bit for bit. Non-finite float features are
rejected before quantization.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.tree import concatenate_ptrees
from repro_torch.datasets.synthetic import quantize_u8
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.qmatmul import code_buffer
from repro_torch.kernels import tree_infer

BACKENDS = ("kernel", "reference")
GRANULE = 8  # smallest bucket (the JAX package's sweep granule)


def round_up_pow2(n: int, granule: int = GRANULE) -> int:
    """Next power of two >= max(n, granule)."""
    n = max(int(n), int(granule))
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclasses.dataclass
class ServeSlot:
    """One static buffer pair of a bucket."""

    x: torch.Tensor      # (bucket, F) int32 master codes
    preds: torch.Tensor  # (bucket,) int32 predicted classes
    count: int = 0       # steps this slot has served


@dataclasses.dataclass
class ServeStats:
    """Serving counters (mutated in place by `ClassifyServer`)."""

    n_requests: int = 0
    n_samples: int = 0
    n_steps: int = 0
    steps_per_bucket: dict = dataclasses.field(default_factory=dict)


class ClassifyServer:
    """Serve one fixed approximate design: a tree (this constructor) or a
    printed MLP (`for_mlp`).

    ptrees: `[ParallelTree]`, one per tree of a forest (e.g.
    `ParetoArtifact.ptrees()`), served as one block-diagonal super-tree
    whose votes count one per tree; bits, t_int: (N,) concatenated decoded
    precisions and substituted thresholds, pre-truncation;
    trunc: (N,) truncated-LSB counts or None; vote_adder: "exact" or
    "approx" (inert for a single tree); n_features: request width the
    design reads (default: widest comparator feature + 1); backend:
    "kernel" or "reference"; max_batch: largest bucket; device: where the
    buffers and the kernel live.
    """

    def __init__(self, ptrees, bits, t_int, n_classes: int,
                 n_features: int | None = None, *, trunc=None,
                 vote_adder: str = "exact", backend: str = "kernel",
                 max_batch: int = 1024, granule: int = GRANULE,
                 device="cuda"):
        if vote_adder not in quant.VOTE_ADDER_MODES:
            raise ValueError(
                f"unknown vote_adder {vote_adder!r}; "
                f"options: {quant.VOTE_ADDER_MODES}")
        self._init_serving(backend, max_batch, granule, device)
        self.family = "tree"
        arrays = concatenate_ptrees(ptrees)
        self.feature = np.asarray(arrays["feature"], np.int32)
        n = self.feature.shape[0]
        bits = np.asarray(bits, np.int32)
        t_int = np.asarray(t_int, np.int32)
        trunc = (np.zeros(n, np.int32) if trunc is None
                 else np.asarray(trunc, np.int32))
        if bits.shape != (n,) or t_int.shape != (n,) or trunc.shape != (n,):
            raise ValueError(
                f"design arrays bits{bits.shape}/t_int{t_int.shape}/"
                f"trunc{trunc.shape} do not match the tree's "
                f"{n} comparators")
        if n and (trunc.min() < 0 or trunc.max() > quant.MAX_TRUNC):
            raise ValueError(
                f"trunc values must lie in [0, {quant.MAX_TRUNC}], got "
                f"range [{trunc.min()}, {trunc.max()}]")
        self.bits = bits
        self.t_int = t_int
        self.trunc = trunc
        self.vote_adder = vote_adder
        self.n_classes = int(n_classes)
        self.n_features = int(n_features) if n_features is not None else (
            int(self.feature.max()) + 1 if n else 1)
        if n and self.n_features <= int(self.feature.max()):
            raise ValueError(
                f"n_features={self.n_features} but a comparator reads "
                f"feature {int(self.feature.max())}")

        # design + operands are built once; every bucket reuses them
        self._design = kops.prepare_design(bits, t_int, trunc=trunc,
                                           vote_adder=vote_adder,
                                           device=self.device)
        self._operands = kops.prepare_operands(
            arrays["feature"], arrays["path"], arrays["path_len"],
            arrays["n_neg"], arrays["leaf_class"], self.n_classes,
            self.n_features, device=self.device)

    def _init_serving(self, backend: str, max_batch: int, granule: int,
                      device) -> None:
        """The settings and buffers every family's server shares."""
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown serving backend {backend!r}; options: {BACKENDS}")
        if max_batch < granule:
            raise ValueError(f"max_batch={max_batch} < granule={granule}")
        self.device = resolve_device(device)
        self.backend = backend
        self.max_batch = int(max_batch)
        self.granule = int(granule)
        self.stats = ServeStats()
        self._slots: dict[int, list[ServeSlot]] = {}
        self._slot_idx: dict[int, int] = {}

    @classmethod
    def for_mlp(cls, w1, w2, shift: int, n_classes: int,
                n_features: int | None = None, *, backend: str = "kernel",
                max_batch: int = 1024, granule: int = GRANULE,
                device="cuda") -> "ClassifyServer":
        """Serve a printed-MLP design: effective integer weights w1 (F, H)
        and w2 (H, C), the static ReLU right shift. The same bucketed
        two-slot machinery as the tree server; only the classify step
        differs (`_infer`)."""
        w1 = np.asarray(w1, np.int32)
        w2 = np.asarray(w2, np.int32)
        if w1.ndim != 2 or w2.ndim != 2 or w2.shape[0] != w1.shape[1]:
            raise ValueError(
                f"weight shapes w1{w1.shape}/w2{w2.shape} do not chain "
                f"(expected (F, H) @ (H, C))")
        if w2.shape[1] != n_classes:
            raise ValueError(
                f"w2 has {w2.shape[1]} output columns for "
                f"n_classes={n_classes}")
        if w1.size and (w1.min() < -128 or w1.max() > 127):
            raise ValueError("w1 weights must fit int8 for the qmatmul kernel")
        self = cls.__new__(cls)
        self._init_serving(backend, max_batch, granule, device)
        self.family = "mlp"
        self.w1 = w1
        self.w2 = w2
        self.shift = int(shift)
        self.n_classes = int(n_classes)
        self.n_features = (int(n_features) if n_features is not None
                           else int(w1.shape[0]))
        if self.n_features != w1.shape[0]:
            raise ValueError(
                f"n_features={self.n_features} but w1 reads {w1.shape[0]} "
                f"features")
        dev = self.device
        self._mlp = dict(
            w1_i8=torch.as_tensor(w1, device=dev).to(torch.int8),
            w1_f=torch.as_tensor(w1, device=dev).to(torch.float64),
            w2_f=torch.as_tensor(w2, device=dev).to(torch.float64),
            ones=torch.ones((w1.shape[1],), dtype=torch.float32, device=dev),
        )
        return self

    @classmethod
    def from_artifact(cls, artifact, point: int | str = "best",
                      max_loss: float = 0.01, **opts) -> "ClassifyServer":
        """Serve a `pareto.json` point: ``artifact`` is a loaded artifact of
        either family (`search.ParetoArtifact`, `families.printed_mlp.
        MlpParetoArtifact`) or a path; ``point`` an index or "best" (the
        smallest-area point within ``max_loss``)."""
        from repro_torch.search import artifact as _artifact

        if isinstance(artifact, str):
            artifact = _artifact.load_pareto_artifact(artifact)
        if point == "best":
            idx = artifact.best_under_loss(max_loss)
            if idx is None:
                raise ValueError(
                    f"no pareto point within max_loss={max_loss}; "
                    f"losses: {[p['acc_loss'] for p in artifact.points]}")
        else:
            idx = int(point)
            if not 0 <= idx < len(artifact.points):
                raise ValueError(
                    f"pareto point {idx} out of range "
                    f"(artifact has {len(artifact.points)} points)")
        if artifact.family == "mlp":
            w1, w2 = artifact.point_design(idx)
            server = cls.for_mlp(w1, w2, artifact.shift, artifact.n_classes,
                                 artifact.n_features, **opts)
        else:
            bits, t_int, trunc, vote_adder = artifact.point_design(idx)
            server = cls(artifact.ptrees(), bits, t_int, artifact.n_classes,
                         trunc=trunc, vote_adder=vote_adder, **opts)
        server.artifact = artifact
        server.point_index = idx
        return server

    # -- the three serving stages -----------------------------------------

    def featurize(self, x) -> np.ndarray:
        """Float features in [0, 1] (n, F) -> master 8-bit codes (n, F)."""
        return quantize_u8(np.asarray(x))

    def sanitize(self, codes) -> np.ndarray:
        """Integer codes -> the 8 input bits the circuit reads (a mask: out
        of grid values wrap mod 256, as in hardware)."""
        return (np.asarray(codes).astype(np.int64) & 0xFF).astype(np.int32)

    def bucket_for(self, n: int) -> int:
        """Power-of-two batch bucket serving a request of n rows."""
        return min(self.max_batch, round_up_pow2(n, self.granule))

    def batch(self, codes) -> list[tuple[np.ndarray, int]]:
        """Pad request codes up to bucket shape(s): [(padded (bucket, F)
        int32, n_real)], one entry per ``max_batch`` chunk. Padding rows
        are zero."""
        codes = np.asarray(codes, np.int32)
        if codes.ndim != 2:
            raise ValueError(f"expected (n, F) codes, got shape {codes.shape}")
        if codes.shape[1] < self.n_features:
            raise ValueError(
                f"request has {codes.shape[1]} features; the design reads "
                f"{self.n_features}")
        out = []
        for lo in range(0, codes.shape[0], self.max_batch) or [0]:
            chunk = codes[lo:lo + self.max_batch]
            bucket = self.bucket_for(chunk.shape[0])
            padded = np.zeros((bucket, codes.shape[1]), np.int32)
            padded[:chunk.shape[0]] = chunk
            out.append((padded, chunk.shape[0]))
        return out

    def classify_codes(self, codes) -> np.ndarray:
        """(n, F) integer master codes -> (n,) predicted classes."""
        codes = self.sanitize(codes)
        self.stats.n_requests += 1
        self.stats.n_samples += int(codes.shape[0])
        if codes.shape[0] == 0:
            return np.zeros((0,), np.int32)
        preds = [self.step(padded)[:n].cpu().numpy()
                 for padded, n in self.batch(codes)]
        return np.concatenate(preds).astype(np.int32)

    def classify(self, x) -> np.ndarray:
        """Serve one request: (n, F) features -> (n,) predicted classes.
        Float inputs are featurized (non-finite values raise ValueError);
        integer inputs are codes, masked to 8 bits."""
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return self.classify_codes(x)
        bad = ~np.isfinite(x)
        if bad.any():
            rows = np.unique(np.nonzero(bad)[0])[:8]
            raise ValueError(
                f"classify: non-finite feature values (NaN/inf) in "
                f"{int(bad.sum())} entries (rows {rows.tolist()}...); "
                f"features must be finite floats in [0, 1]")
        return self.classify_codes(self.featurize(x))

    # -- bucketed two-slot step -------------------------------------------

    def step(self, padded: np.ndarray) -> torch.Tensor:
        """Run one bucket-shaped batch through the bucket's next slot;
        returns the slot's (bucket,) prediction buffer on the device."""
        bucket = int(padded.shape[0])
        slots = self._slots.get(bucket)
        if slots is None:
            slots = self._slots[bucket] = [
                ServeSlot(
                    x=torch.zeros((bucket, self.n_features), dtype=torch.int32,
                                  device=self.device),
                    preds=torch.zeros((bucket,), dtype=torch.int32,
                                      device=self.device))
                for _ in range(2)]
            self._slot_idx[bucket] = 0
        idx = self._slot_idx[bucket]
        slot = slots[idx]
        slot.x.copy_(torch.from_numpy(
            np.ascontiguousarray(padded[:, :self.n_features])))
        slot.preds.copy_(self._infer(slot.x))
        slot.count += 1
        self._slot_idx[bucket] = idx ^ 1
        self.stats.n_steps += 1
        self.stats.steps_per_bucket[bucket] = (
            self.stats.steps_per_bucket.get(bucket, 0) + 1)
        return slot.preds

    def _infer(self, x8: torch.Tensor) -> torch.Tensor:
        """(bucket, F) codes -> (bucket,) predictions, selected backend:
        the kernel, or the plain dataflow on any device."""
        if self.family == "mlp":
            m = self._mlp
            if self.backend == "kernel":   # the codes are already & 0xFF
                h = kops.qmatmul(code_buffer(x8), m["w1_i8"], m["ones"])
            else:
                h = (x8.to(torch.float64) @ m["w1_f"]).to(torch.float32)
            hq = torch.floor(torch.clamp(h, min=0.0) * 2.0 ** -self.shift)
            return torch.argmax(hq.to(torch.float64) @ m["w2_f"], dim=1)
        if self.backend == "kernel":
            return kops.classify(x8, self._operands, self._design)
        shift, thr, vote_cap = self._design
        votes = tree_infer.tree_infer_scores_plain(x8, self._operands, shift,
                                                   thr)[0]
        return torch.argmax(torch.minimum(votes, vote_cap), dim=-1)

    def compiled_buckets(self) -> list[int]:
        """Buckets that have buffers (the JAX server's compiled steps)."""
        return sorted(self._slots)
