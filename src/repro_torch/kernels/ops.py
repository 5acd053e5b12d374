"""Operand preparation and call sites of the port's kernels.

The counterpart of `repro.kernels.ops`. The TPU wrappers padded every axis
to (8, 128) tiles and turned integers into float32; the Hopper kernels work
on integers, so here the static operands are the path matrix packed into
bit masks (`tree_infer_scores`, which masks its ragged edges) or padded
with zeros to the int8 tensor cores' K-contiguous layout
(`fitness_correct_counts`), and the per-chromosome operands are int32
shifts (``8 - bits``, in place of the float scale ``2^-(8-bits)``) and
thresholds. Each function runs where its tensors lie: the kernels on a
CUDA tensor, their plain versions on a CPU tensor.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.core.tree import concatenate_ptrees
from repro_torch.kernels import domination as _dom
from repro_torch.kernels import fitness as _fit
from repro_torch.kernels import qmatmul as _qmm
from repro_torch.kernels import tree_infer as _ti


def _as_int32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int32).contiguous()


def _leaf_operands(path, path_len, n_neg, leaf_class, n_classes: int, device):
    path = torch.as_tensor(path, device=device).to(torch.int8).contiguous()
    leaf_class = _as_int32(leaf_class, device)
    if leaf_class.numel() and not (0 <= int(leaf_class.min())
                                   and int(leaf_class.max()) < n_classes):
        raise ValueError(f"leaf classes must lie in [0, {n_classes})")
    target = _as_int32(path_len, device) - _as_int32(n_neg, device)
    return path, target, leaf_class


def prepare_operands(feature, path, path_len, n_neg, leaf_class,
                     n_classes: int, n_features: int,
                     device=None) -> _ti.TreeOperands:
    """Static `tree_infer_scores` operands from comparator/leaf arrays
    (``device`` defaults to where ``path`` lies)."""
    device = device if device is not None else torch.as_tensor(path).device
    path, target, leaf_class = _leaf_operands(
        path, path_len, n_neg, leaf_class, n_classes, device)
    packed = _ti.pack_path(path)
    feature = _as_int32(feature, device)
    if feature.numel() and not (0 <= int(feature.min())
                                and int(feature.max()) < n_features):
        raise ValueError(f"comparator features must lie in [0, {n_features})")
    return _ti.TreeOperands(
        feature=feature, path=path, pos=packed.pos, neg=packed.neg,
        word_off=packed.word_off, target=target, leaf_class=leaf_class,
        n_classes=int(n_classes), n_features=int(n_features),
        nwp=packed.nwp, n_seg=packed.n_seg, d_words=packed.d_words)


def prepare_forest_operands(ptrees, n_features: int,
                            device="cuda") -> _ti.TreeOperands:
    """Static `tree_infer_scores` operands of a forest laid out as one
    block-diagonal super-tree (`core.tree.concatenate_ptrees`): each leaf
    row sees only its own tree's comparators, and exactly one leaf per tree
    fires, so the votes count one per tree and class and their first-max
    argmax is the majority vote. A single tree is the K = 1 case
    (`prepare_tree_operands`)."""
    arrays = concatenate_ptrees(ptrees)
    return prepare_operands(
        arrays["feature"], arrays["path"], arrays["path_len"],
        arrays["n_neg"], arrays["leaf_class"],
        max(pt.n_classes for pt in ptrees), n_features, device=device)


def prepare_tree_operands(pt, n_features: int,
                          device="cuda") -> _ti.TreeOperands:
    """Single-tree operands: the K = 1 case of `prepare_forest_operands`."""
    return prepare_forest_operands([pt], n_features, device=device)


def prepare_fitness_operands(x_sel, y, path, path_len, n_neg, leaf_class,
                             n_classes: int,
                             device=None) -> _fit.FitnessOperands:
    """Chromosome-invariant `fitness_correct_counts` operands in the
    kernel's layout. ``x_sel`` is the hoisted gather ``x8[:, feature]``
    (B, N) of codes in [0, 255]. The comparator axis is padded with zeros
    to `fitness.k_padded(N)` and the leaf axis to a multiple of
    `fitness.LEAF_TILE`, padded leaves getting the target N + 1, which no
    score (|d . PATH[l]| <= N) reaches; each leaf tile gets its comparator
    span (`fitness.tile_spans`)."""
    device = device if device is not None else torch.as_tensor(x_sel).device
    x_sel = torch.as_tensor(x_sel, device=device)
    if x_sel.numel() and not (0 <= int(x_sel.min()) and int(x_sel.max()) <= 255):
        raise ValueError("x_sel codes must lie in [0, 255]")
    y = _as_int32(y, device)
    path, target, leaf_class = _leaf_operands(
        path, path_len, n_neg, leaf_class, n_classes, device)
    n_leaves, n = path.shape
    k_pad = _fit.k_padded(n)
    l_pad = -(-n_leaves // _fit.LEAF_TILE) * _fit.LEAF_TILE
    codes = torch.zeros((x_sel.shape[0], k_pad), dtype=torch.uint8,
                        device=device)
    codes[:, :n] = x_sel
    path_pad = torch.zeros((l_pad, k_pad), dtype=torch.int8, device=device)
    path_pad[:n_leaves, :n] = path
    target_pad = torch.full((l_pad,), n + 1, dtype=torch.int32, device=device)
    target_pad[:n_leaves] = target
    class_pad = torch.zeros((l_pad,), dtype=torch.int32, device=device)
    class_pad[:n_leaves] = leaf_class
    spans, chunk, columns = _fit.tile_spans(path_pad)
    return _fit.FitnessOperands(
        x_sel=codes, y=y, path=path_pad, spans=spans, target=target_pad,
        leaf_class=class_pad, n_comparators=int(n),
        n_classes=int(n_classes), n_valid=int((y >= 0).sum()), chunk=chunk,
        span_columns=columns)


def decode_population_full(threshold: torch.Tensor, genes: torch.Tensor):
    """ONE gene decode shared by the accuracy and area terms.

    threshold (N,) float32; genes (P, 3N+1). Returns (shift, t_eff,
    bits_eff, vote_cap): (P, N) int32 effective operands with LSB truncation
    folded in (width p - k, threshold t' >> k, shift 8 - p + k) and the
    (P,) int32 vote cap.
    """
    bits, margin, trunc, vote = quant.decode_tree_genes(genes)
    t_int = quant.threshold_to_int(threshold[None, :], bits)
    t_sub = quant.substitute(t_int, margin, bits)
    bits_eff = bits - trunc
    t_eff = t_sub >> trunc
    shift = (quant.MASTER_BITS - bits_eff).contiguous()
    return shift, t_eff.contiguous(), bits_eff, quant.vote_cap_of(vote)


def decode_population(threshold: torch.Tensor, genes: torch.Tensor):
    """(shift, thr, vote_cap) kernel operands from genes (P, 3N+1)."""
    shift, t_eff, _, vote_cap = decode_population_full(threshold, genes)
    return shift, t_eff, vote_cap


def fitness_errors(fit_ops: _fit.FitnessOperands, shift: torch.Tensor,
                   thr: torch.Tensor,
                   vote_cap: torch.Tensor | None = None) -> torch.Tensor:
    """(P,) int32 misclassified-sample counts of a population."""
    if vote_cap is None:
        vote_cap = torch.full((shift.shape[0],), quant.NO_VOTE_CAP,
                              dtype=torch.int32, device=shift.device)
    counts = _fit.fitness_correct_counts(fit_ops, shift, thr, vote_cap)
    return fit_ops.n_valid - counts


def tree_infer_predict(x8: torch.Tensor, operands: _ti.TreeOperands,
                       shift: torch.Tensor, thr: torch.Tensor,
                       vote_cap: torch.Tensor | None = None) -> torch.Tensor:
    """(P, B) int64 predicted classes: the kernel's votes clipped to the
    vote cap, first-max argmax."""
    votes = _ti.tree_infer_scores(x8.to(torch.int32).contiguous(), operands,
                                  shift, thr)
    if vote_cap is not None:
        votes = torch.minimum(votes, vote_cap[:, None, None])
    return torch.argmax(votes, dim=-1)


def domination_block(objs_i: torch.Tensor, objs_j: torch.Tensor):
    """(Pi, Pj) float32 {0, 1} domination slab (rows dominate columns)."""
    return domination_block_bool(objs_i, objs_j).to(torch.float32)


def domination_block_bool(objs_i: torch.Tensor, objs_j: torch.Tensor):
    """The slab as the bool matrix `core.nsga2` consumes."""
    return _dom.domination_block(objs_i.to(torch.float32).contiguous(),
                                 objs_j.to(torch.float32).contiguous())


def domination_matrix(objs: torch.Tensor):
    """(P, P) float32 {0, 1} domination matrix."""
    return domination_block(objs, objs)


def domination_matrix_bool(objs: torch.Tensor):
    return domination_block_bool(objs, objs)


def non_dominated_rank(objs: torch.Tensor):
    """(P,) int32 rank of each row of objs (P, M), 0 = first front: on the
    card the packed relation and the front peel, two launches and no host
    sync; on the CPU the host loop."""
    return _dom.non_dominated_rank(objs.to(torch.float32).contiguous())


def prepare_design(bits, t_int, trunc=None, vote_adder: str = "exact",
                   device=None):
    """Fixed-design kernel operands from a decoded pareto point: (shift,
    thr) (1, N) int32 and vote_cap (1,) int32, truncation folded in."""
    if vote_adder not in quant.VOTE_ADDER_MODES:
        raise ValueError(f"unknown vote_adder {vote_adder!r}")
    bits = _as_int32(bits, device)
    t_int = _as_int32(t_int, device)
    if trunc is not None:
        k = _as_int32(trunc, device)
        bits = bits - k
        t_int = t_int >> k
    shift = (quant.MASTER_BITS - bits)[None, :].contiguous()
    cap = 1 if vote_adder == "approx" else quant.NO_VOTE_CAP
    vote_cap = torch.full((1,), cap, dtype=torch.int32, device=bits.device)
    return shift, t_int[None, :].contiguous(), vote_cap


def classify(x8: torch.Tensor, operands: _ti.TreeOperands, design):
    """(B,) predicted classes of ONE fixed design: the P = 1 row."""
    shift, thr, vote_cap = design
    return tree_infer_predict(x8, operands, shift, thr, vote_cap)[0]


def qmatmul(x: torch.Tensor, w_q: torch.Tensor,
            scale: torch.Tensor) -> torch.Tensor:
    """(M, N) float32 ``(x @ w_q) * scale`` for x (M, K) uint8 codes or
    float32/bfloat16, w_q (K, N) int8 and scale (N,) or (1, N) float32. The
    TPU wrapper padded every axis to MXU tiles; the Hopper kernels mask
    their ragged edges, so here the operands are only made contiguous
    (uint8 x keeps its row stride: a `qmatmul.code_buffer` is read as it
    lies)."""
    if x.dtype != torch.uint8 or x.stride(-1) != 1:
        x = x.contiguous()
    return _qmm.qmatmul(x, w_q.contiguous(),
                        scale.to(torch.float32).contiguous())
