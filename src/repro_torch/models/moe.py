"""Mixture-of-Experts: sort-based routing, dispatch at capacity with
drops, batched expert FFN, deterministic combine; on one device and
expert-parallel on a rank of a mesh.

Counterpart of `repro.models.moe`. The names are the JAX package's:
`_route` picks each token's top-k experts and the load-balance loss,
`_dispatch` lays the picks out as an (E, C, D) buffer by a stable sort on
the expert id, `_expert_ffn` runs the three batched products, and
`_combine` (inline in the JAX package's `_moe_local`) adds the weighted
expert outputs back per token. `moe_block` is the local path
(`_moe_local`, what the JAX package runs without a mesh; the config's
`moe_a2a_int8` acts only on a mesh). `moe_block_sharded` is the
expert-parallel one (`_moe_ep`), in the mode `_ep_mode` picks: "alltoall"
exchanges each rank's dispatch buffer with the owners of its experts
(`core.comm.all_to_all_along`, or the int8 `comm.quantized_all_to_all`),
"gathered" gathers the expert weights' d_ff instead and moves no token.

Every step is plain PyTorch on tensors whose shapes depend on the config
and the batch alone (`_capacity` is a Python number), so a block makes no
host sync. Three places keep the JAX package's arithmetic exactly:

- the top-k breaks ties toward the lower expert id, as `lax.top_k` does
  (a stable descending sort);
- a token whose expert is already full (``capacity`` picks of tokens
  earlier in the stable order) is dropped: its pick adds nothing;
- the combine adds each token's k weighted outputs in increasing expert
  id, one after another in the model dtype, which is the order of the JAX
  package's scatter-add over the expert-sorted picks; no atomics, so a
  second call gives the same bits.
"""
from __future__ import annotations

import itertools
import math

import torch

from repro_torch.core import comm
from repro_torch.models.common import activation, is_glu, normal_init


def _fill_normal(gen: torch.Generator, shape, std: float,
                 dtype: torch.dtype) -> torch.Tensor:
    """A (*lead, E, rows, cols) tensor of ``dtype`` filled with normal draws
    times ``std``, one (rows, cols) expert slice at a time: a stacked
    expert weight drawn whole in float32 (grok-1-314b's ``wi`` at 8 layers:
    51.5 GB) would not fit beside the model; one slice of it is 0.8 GB."""
    *outer, rows, cols = shape
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    if out.is_meta:
        return out
    for idx in itertools.product(*(range(n) for n in outer)):
        out[idx].copy_(torch.randn((rows, cols), generator=gen,
                                   dtype=torch.float32, device=gen.device)
                       * std)
    return out


def init_moe(gen: torch.Generator, cfg, dtype: torch.dtype, lead=()) -> dict:
    """Router (D, E) float32 in every model dtype, as the JAX package keeps
    it; expert weights ``wi`` (E, D, F), ``wo`` (E, F, D) and, for GLU
    activations, ``wg`` (E, D, F) in ``dtype``; all with leading axes
    ``lead`` (the layer stack)."""
    d, ff, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p = {
        "router": normal_init(gen, (*lead, d, e), d ** -0.5, torch.float32),
        "wi": _fill_normal(gen, (*lead, e, d, ff), d ** -0.5, dtype),
        "wo": _fill_normal(gen, (*lead, e, ff, d), ff ** -0.5, dtype),
    }
    if is_glu(cfg.act):
        p["wg"] = _fill_normal(gen, (*lead, e, d, ff), d ** -0.5, dtype)
    return p


# ---------------------------------------------------------------------------
# shared routing pieces
# ---------------------------------------------------------------------------

def _route(router: torch.Tensor, cfg, xf: torch.Tensor):
    """xf (T, D) -> (gates (T, k) float32, expert ids (T, k), aux scalar).

    The logits are a float32 product (TF32 must be off on the card, as
    `chip_smoke.py` sets it, or the picks move). The top k come from a
    stable descending sort, so equal logits go to the lower expert id
    first, as `lax.top_k` orders them."""
    e, k = cfg.n_experts, cfg.experts_per_token
    logits = xf.to(torch.float32) @ router                    # (T, E)
    top, eids = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(top[:, :k], dim=-1)
    eids = eids[:, :k]
    probs = torch.softmax(logits, dim=-1)
    t = xf.shape[0]
    flat = eids.reshape(-1)
    counts = torch.zeros(e, dtype=torch.int64, device=xf.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    frac = counts.to(torch.float32) / (t * k)
    aux = e * torch.sum(frac * probs.mean(0))
    return gates, eids, aux


def _dispatch(cfg, xf: torch.Tensor, eids: torch.Tensor, capacity: int):
    """Sort-based dispatch: returns (buf (E, C, D), keep, slot, token_of),
    the last three over the T·k picks in expert-sorted order (a stable
    sort of the flat expert ids, so within an expert the earlier token
    first). A pick past its expert's ``capacity`` is dropped: its slot is
    the sentinel row E·C, which takes every dropped write and is cut off."""
    e, k = cfg.n_experts, cfg.experts_per_token
    t, d = xf.shape
    flat_e = eids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.zeros(e, dtype=flat_e.dtype, device=xf.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * k, device=xf.device) - starts[sorted_e]
    keep = pos_in_e < capacity
    slot = torch.where(keep, sorted_e * capacity + pos_in_e, e * capacity)
    token_of = order // k
    buf = xf.new_zeros((e * capacity + 1, d))
    buf[slot] = xf[token_of]
    return buf[: e * capacity].view(e, capacity, d), keep, slot, token_of


def _expert_ffn(cfg, buf: torch.Tensor, wi: torch.Tensor, wg, wo: torch.Tensor):
    """(E, C, D) -> (E, C, D): each expert's FFN on its C slots, three
    batched products over every expert, as the JAX package's einsums."""
    act = activation(cfg.act)
    h = torch.bmm(buf, wi)
    if wg is not None:
        h = act(torch.bmm(buf, wg)) * h
    else:
        h = act(h)
    return torch.bmm(h, wo)


def _capacity(cfg, t: int) -> int:
    return int(max(1, math.ceil(
        cfg.capacity_factor * t * cfg.experts_per_token / cfg.n_experts)))


# ---------------------------------------------------------------------------
# the local path
# ---------------------------------------------------------------------------

def _combine(out_buf: torch.Tensor, gates: torch.Tensor, eids: torch.Tensor,
             keep: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """(T, D) output in ``out_buf``'s dtype: each token's kept expert
    outputs times their gates (cast to that dtype), added one after another
    in increasing expert id, as the JAX package's scatter-add over the
    expert-sorted picks adds them (`repro.models.moe._moe_local`)."""
    t, k = eids.shape
    d = out_buf.shape[-1]
    out_flat = out_buf.reshape(-1, d)
    src = slot.clamp(max=out_flat.shape[0] - 1)
    order = torch.argsort(eids.reshape(-1), stable=True)
    w = gates.reshape(-1)[order].to(out_buf.dtype)
    # each token's picks as positions in the expert-sorted order, lowest
    # expert id first
    pos = torch.empty_like(order)
    pos[order] = torch.arange(t * k, device=order.device)
    pos = pos.view(t, k).sort(dim=1).values
    y = out_buf.new_zeros((t, d))
    for r in range(k):
        p = pos[:, r]
        gathered = torch.where(keep[p, None], out_flat[src[p]], 0.0)
        y = y + gathered * w[p, None]
    return y


def _moe_local(params: dict, cfg, x: torch.Tensor):
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    gates, eids, aux = _route(params["router"], cfg, xf)
    capacity = _capacity(cfg, b * s)
    buf, keep, slot, _ = _dispatch(cfg, xf, eids, capacity)
    out_buf = _expert_ffn(cfg, buf, params["wi"], params.get("wg"),
                          params["wo"])
    y = _combine(out_buf, gates, eids, keep, slot)
    return y.reshape(b, s, d), aux


def _dispatch_size(rules) -> int:
    """Ranks of the expert all-to-all: the product of ``rules.expert``'s
    axis sizes on ``rules.mesh``."""
    from repro_torch.sharding.rules import mesh_axes

    if not rules.expert:
        return 1
    sizes = mesh_axes(rules.mesh)
    return math.prod(int(sizes[a]) for a in rules.expert)


def _ep_mode(cfg, rules) -> str:
    """"alltoall" when the experts divide over the dispatch ranks, else
    "gathered" (each rank holds every expert, its d_ff over
    ``rules.ff_wide``)."""
    dp = _dispatch_size(rules)
    if cfg.n_experts >= dp and cfg.n_experts % dp == 0 and dp > 1:
        return "alltoall"
    return "gathered"


def moe_block(params: dict, cfg, x: torch.Tensor):
    """x (B, S, D) -> ((B, S, D), aux_loss)."""
    return _moe_local(params, cfg, x)


def moe_block_sharded(params: dict, cfg, z: torch.Tensor, lay,
                      specs: dict, seq_sharded: bool = True):
    """The MoE block on a rank of a mesh (the JAX package's `_moe_ep`).
    With ``seq_sharded`` (the train step and prefill), ``z`` (B, S/tp, D)
    is this rank's sequence block of the normed residual and the block
    returns (its block of the output, (B, S/tp, D), this rank's
    load-balance loss). Without it (decode), ``z`` (B, 1, D) is the whole
    one-token input, the same on every model rank, and so is the output.
    ``specs`` lays out ``params`` (one layer's).

    Each rank routes its own tokens at its own capacity (`_capacity` of
    its token count) and its aux is over them alone, as the JAX package's
    ranks do; the caller averages the aux over every rank
    (`models.lm.lm_loss`). The router is used whole on every rank, so its
    gradient is summed over every rank that routed with it
    (`Layout.weight`).

    "alltoall" (the experts divide over the expert axes): a sharded
    sequence is gathered over ``model``; the tokens are routed and
    dispatched, and the expert-major (dp, E/dp, C, D) view of the buffer
    exchanged over the expert axes (int8 when ``cfg.moe_a2a_int8``); the
    rank's experts run on its d_ff block; the partial outputs come back by
    a second exchange (int8 too in decode, as the JAX package sends it
    there alone) and are combined, then reduce-scattered over ``model``
    onto the sequence (decode: all-reduced over ``model``). The expert
    weights' gradients come back whole on their owner.
    "gathered": the tokens stay; ``wi``, ``wg`` and ``wo`` are gathered
    along d_ff over every axis of ``rules.ff_wide`` (their gradients
    reduce-scattered back by autograd) and the output is complete."""
    from repro_torch.sharding import params as sp

    d = z.shape[-1]
    router = lay.weight(params["router"], specs["router"])
    alltoall = lay.ep_mode == "alltoall"
    x = comm.gather_along(z, lay.model_group, 1) \
        if alltoall and seq_sharded else z
    b, s, _ = x.shape
    t = b * s
    xf = x.reshape(t, d)
    gates, eids, aux = _route(router, cfg, xf)
    capacity = _capacity(cfg, t)
    buf, keep, slot, _ = _dispatch(cfg, xf, eids, capacity)
    if alltoall:
        group = lay.expert_group
        e_loc = params["wi"].shape[0]
        send = buf.reshape(-1, e_loc, capacity, d)       # (dp, e_loc, C, D)
        recv = (comm.quantized_all_to_all(send, group) if cfg.moe_a2a_int8
                else comm.all_to_all_along(send, group))
        act = activation(cfg.act)
        h = torch.einsum("sjcd,jdf->sjcf", recv, params["wi"])
        if "wg" in params:
            h = act(torch.einsum("sjcd,jdf->sjcf", recv, params["wg"])) * h
        else:
            h = act(h)
        out = torch.einsum("sjcf,jfd->sjcd", h, params["wo"])
        out = (comm.quantized_all_to_all(out, group)
               if cfg.moe_a2a_int8 and not seq_sharded
               else comm.all_to_all_along(out, group))
        out_buf = out.reshape(cfg.n_experts, capacity, d)
    else:
        w = {}
        for k, dim in (("wi", 2), ("wg", 2), ("wo", 1)):
            if k in params:
                w[k] = params[k]
                for a in reversed(sp.entry_axes(specs[k][dim])):
                    w[k] = comm.gather_along(w[k], lay.mesh.get_group(a),
                                             dim)
        out_buf = _expert_ffn(cfg, buf, w["wi"], w.get("wg"), w["wo"])
    y = _combine(out_buf, gates, eids, keep, slot).reshape(b, s, d)
    if alltoall:
        y = (comm.reduce_scatter_along(y, lay.model_group, 1) if seq_sharded
             else comm.reduce_from_group(y, lay.model_group))
    return y, aux
