"""The paper's dual approximation carried over to LM weights.

Counterpart of `repro.quantize.bespoke`. `snap_lut`: each integer code
moves, within +/-margin, to the code with the cheapest multiplier: the
fewest set bits of |code|, ties to the smallest step. In a bespoke printed
MAC the cost of a constant multiplier tracks its set bits, so this is the
comparator threshold substitution carried over to MAC weights; the
printed-MLP family decodes every weight through it.

The LM half: per quantizable tensor (every >= 2-D weight but norms and
convs, named by its JAX tree path), two genes, precision (bits in [2, 8],
symmetric per-output-channel codes) and margin (a snap window in [0, 5]).
`apply_chromosome` replaces each weight by its dequantized codes (float
emulation, as in the JAX package: no `qmatmul` here) and prices the codes
(`tensor_cost`: bits for memory, set bits for the multipliers, over the
float model's bf16 bytes); `make_lm_quant_problem` scores a population by
(quantized loss - float loss, cost) with the caller's loss, in the port
`models.lm.lm_loss`. The codes are computed on the host in numpy from
float32 copies, as the JAX package computes them.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.core import quant as core_quant


def _popcount(v: int) -> int:
    return bin(abs(v)).count("1")


@functools.lru_cache(maxsize=64)
def snap_lut(bits: int, margin: int) -> np.ndarray:
    """code (two's complement int in [-2^(b-1), 2^(b-1)-1]) -> snapped code,
    indexed by ``code - lo``.

    The single-step snap is chased to a FIXPOINT: one step can land on a
    code that itself snaps cheaper (bits=8, margin=2: 19 -> 18 -> 16), and
    re-snapping already snapped weights, as the printed-MLP decode does
    through its precision ladder, must not drift. The chase ends because
    each hop strictly lowers the (popcount, |step|) key; margin 0 is the
    identity and no code leaves [lo, hi]. The cached array is shared by
    every caller, so it is returned read-only.
    """
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    out = np.zeros(1 << bits, dtype=np.int32)
    for code in range(lo, hi + 1):
        best, best_key = code, (_popcount(code), 0)
        for d in range(-margin, margin + 1):
            c = code + d
            if c < lo or c > hi:
                continue
            key = (_popcount(c), abs(d))
            if key < best_key:
                best, best_key = c, key
        out[code - lo] = best
    for idx in range(out.shape[0]):
        for _ in range(out.shape[0]):
            nxt = int(out[int(out[idx]) - lo])
            if nxt == int(out[idx]):
                break
            out[idx] = nxt
    out.flags.writeable = False
    return out


def quantize_tensor(w, bits: int, margin: int):
    """w (.., K, N) float -> (codes int8, scale (.., 1, N) float32), per
    output channel, snapped within ``margin``."""
    if isinstance(w, torch.Tensor):
        w = w.detach().to(torch.float32).cpu().numpy()
    wf = np.asarray(w, np.float32)
    amax = np.max(np.abs(wf), axis=-2, keepdims=True)
    scale = np.maximum(amax, 1e-9) / ((1 << (bits - 1)) - 1)
    codes = np.clip(np.round(wf / scale), -(1 << (bits - 1)),
                    (1 << (bits - 1)) - 1).astype(np.int32)
    if margin > 0:
        lut = snap_lut(bits, margin)
        codes = lut[codes + (1 << (bits - 1))]
    return codes.astype(np.int8), scale.astype(np.float32)


def dequantize_tensor(codes, scale):
    return codes.astype(np.float32) * scale


def tensor_cost(codes, bits: int, alpha: float = 0.5) -> float:
    """Mixed memory (bits) + multiplier (popcount) cost, per tensor."""
    pop = np.unpackbits(np.abs(codes.astype(np.int16)).astype(np.uint8)
                        [..., None], axis=-1).sum()
    return alpha * codes.size * bits / 8.0 + (1 - alpha) * float(pop) / 8.0


def quantizable_tensors(params) -> list[tuple[str, tuple]]:
    """All >= 2-D weight tensors (matmul operands) with their tree paths,
    in the JAX package's leaf order, named as it names them."""
    out = []
    for path, leaf in pytree.leaves_with_paths(params):
        name = pytree.path_str(path)
        if leaf.dim() >= 2 and "norm" not in name and "conv" not in name:
            out.append((name, path))
    return out


def apply_chromosome(params, genes: np.ndarray):
    """Decode (2T,) genes and return (quantized params, total cost): a new
    tree whose quantizable weights are their dequantized codes in the
    weight's dtype and device, the other leaves shared with ``params``."""
    tensors = quantizable_tensors(params)
    span_p = core_quant.MAX_BITS - core_quant.MIN_BITS + 1
    bits = (core_quant.MIN_BITS
            + np.clip(np.floor(genes[0::2] * span_p), 0, span_p - 1)
            ).astype(int)
    margins = np.clip(np.floor(genes[1::2] * 6), 0, 5).astype(int)
    qparams = pytree.tree_map(lambda t: t, params)
    total_cost = 0.0
    float_cost = 0.0
    for i, (_, path) in enumerate(tensors):
        leaf = pytree.get(params, path)
        codes, scale = quantize_tensor(leaf, int(bits[i]), int(margins[i]))
        total_cost += tensor_cost(codes, int(bits[i]))
        float_cost += leaf.numel() * 2.0  # bf16 bytes baseline
        pytree.put(qparams, path, torch.as_tensor(
            dequantize_tensor(codes, scale)).to(dtype=leaf.dtype,
                                                device=leaf.device))
    return qparams, total_cost / max(float_cost, 1e-9)


def make_lm_quant_problem(params, cfg, batch, loss_fn):
    """Fitness closure for NSGA-II over per-tensor (bits, margin) genes:
    (fitness_np, n_genes, base_loss), fitness_np(pop (P, 2T)) -> (P, 2)
    float32 objectives (loss increase, cost); ``loss_fn(params, batch)``
    a scalar, e.g. `models.lm.lm_loss`'s loss."""
    with torch.no_grad():
        base_loss = float(loss_fn(params, batch))
    n_tensors = len(quantizable_tensors(params))

    def fitness_np(pop: np.ndarray) -> np.ndarray:
        objs = np.zeros((pop.shape[0], 2), np.float32)
        for i, genes in enumerate(pop):
            qparams, cost = apply_chromosome(params, np.asarray(genes))
            with torch.no_grad():
                loss = float(loss_fn(qparams, batch))
            objs[i] = (loss - base_loss, cost)
        return objs

    return fitness_np, 2 * n_tensors, base_loss
