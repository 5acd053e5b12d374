"""GQA/MQA attention with RoPE: flash prefill, KV-cache decode.

Counterpart of `repro.models.attention`. On one device the JAX package's
`head_sharding` gives `("replicated", 1)`, so kv heads are never repeated;
`attention_block_sharded` is the training and prefill block on a rank of
a mesh (`sharding.spmd`), in both of `head_sharding`'s modes, and
`decode_block_sharded` the one-token block, context-parallel over a KV
cache sharded along the sequence (each rank's share by `decode_partials`,
the shares joined by `combine_partials`: what GSPMD derives from the JAX
package's sequence-sharded cache). Prefill attention goes through the
hand-written `flash_attention` kernel (`kernels/flash_attn.py`, its
model-layout wrapper `flash_attention_bshd`), which computes what the JAX
package's `chunked_prefill_attention` computes; decode attends over the
whole preallocated cache with a position mask in plain PyTorch, as the JAX
package does outside any Pallas kernel; so do the sharded decode's shares
and their combine.
"""
from __future__ import annotations

import torch

from repro_torch.core import comm
from repro_torch.kernels.flash_attn import flash_attention_bshd
from repro_torch.models.common import apply_rope, normal_init

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg, dtype: torch.dtype,
                   lead=()) -> dict:
    """Attention weights, with leading axes ``lead`` (the layer stack)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    std = d ** -0.5
    return {
        "wq": normal_init(gen, (*lead, d, h, hd), std, dtype),
        "wk": normal_init(gen, (*lead, d, kv, hd), std, dtype),
        "wv": normal_init(gen, (*lead, d, kv, hd), std, dtype),
        "wo": normal_init(gen, (*lead, h, hd, d), (h * hd) ** -0.5, dtype),
    }


def _group_query(q: torch.Tensor, kv: int) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, KV, G, hd) with head h -> group h // G."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, kv, h // kv, hd)


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return torch.tanh(scores / cap) * cap
    return scores


def chunked_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *,
                              softcap: float = 0.0) -> torch.Tensor:
    """Causal attention through the `flash_attention` kernel, in the model's
    own layout.

    q (B, S, KV, G, hd); k, v (B, S, KV, hd). Returns (B, S, KV, G, hd).
    q's (KV, G) axes are read as H = KV·G heads, so query head kv·G + g
    reads kv head kv, its index // G; the kernel takes the (B, S, heads, hd)
    strides, so nothing is permuted or copied around it. Any S works: the
    kernel masks the ragged edge.
    """
    b, s, kv, g, hd = q.shape
    out = flash_attention_bshd(q.reshape(b, s, kv * g, hd), k, v,
                               softcap=softcap)
    return out.reshape(b, s, kv, g, hd)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: int, *,
                     softcap: float = 0.0) -> torch.Tensor:
    """One-token attention over the preallocated cache.

    q (B, 1, KV, G, hd); caches (B, S_max, KV, hd); ``length`` = #valid.
    """
    s_max = k_cache.shape[1]
    sc = torch.einsum("bqkgh,bskh->bkgqs", q.to(torch.float32),
                      k_cache.to(torch.float32)) * (q.shape[-1] ** -0.5)
    sc = _softcap(sc, softcap)
    valid = torch.arange(s_max, device=q.device) < length
    sc = torch.where(valid, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v_cache.to(torch.float32))
    return out.to(q.dtype)


def attention_block(params: dict, cfg, x: torch.Tensor,
                    positions: torch.Tensor, *, cache=None, cache_pos=None,
                    cache_layer=None):
    """Full attention sub-block.

    Prefill: cache=None; returns (out, this block's fresh (k, v)), each
    (B, S, KV, hd). Decode: cache=(k_stack, v_stack), the full
    (L, B, S_max, KV, hd) caches; the new token's k and v are written in
    place at (cache_layer, :, cache_pos) and the same stacks are returned.
    """
    b, s, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"].reshape(d, h * hd)).reshape(b, s, h, hd)
    k = (x @ params["wk"].reshape(d, kv * hd)).reshape(b, s, kv, hd)
    v = (x @ params["wv"].reshape(d, kv * hd)).reshape(b, s, kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    qg = _group_query(q, kv)
    if cache is None:
        out = chunked_prefill_attention(qg, k, v, softcap=cfg.attn_softcap)
        new_kv = (k, v)
    else:
        k_stack, v_stack = cache
        layer = cache_layer if cache_layer is not None else 0
        k_stack[layer, :, cache_pos:cache_pos + s] = k
        v_stack[layer, :, cache_pos:cache_pos + s] = v
        out = decode_attention(qg, k_stack[layer], v_stack[layer],
                               cache_pos + s, softcap=cfg.attn_softcap)
        new_kv = (k_stack, v_stack)

    out = out.reshape(b, s, h * hd)
    y = out @ params["wo"].reshape(h * hd, d)
    return y, new_kv


def attention_block_sharded(params: dict, cfg, z: torch.Tensor, lay,
                            specs: dict, kv_out: bool = False):
    """The training and prefill attention block on a rank of a mesh: ``z``
    (B, S/tp, D) this rank's sequence block of the normed residual;
    returns its block of the block's output, (B, S/tp, D), and with
    ``kv_out`` also the prompt's keys and values for the decode cache,
    each (B, S, KV, hd) on the true kv heads over the whole sequence
    (`_prompt_kv`). ``specs`` lays out ``params`` (one layer's).

    "sharded" mode: the rank's heads. The input is gathered along the
    sequence; ``wq`` and ``wo`` hold the rank's heads (column- and
    row-parallel); ``wk`` and ``wv`` too, or, when the kv heads do not
    divide over ``model``, the whole weights (ZeRO-3-gathered over
    ``data``) repeated ``kv_repeat`` times along the heads and then cut to
    the rank's, as the JAX package repeats the weight before sharding it;
    the output's partial sums are reduce-scattered back onto the sequence.

    "replicated" mode (heads that do not divide over ``model``): every
    head on every rank, the queries of the rank's sequence block only
    (context parallelism), keys and values over the whole gathered
    sequence. The causal kernel sees query i against keys 0..i, so the
    rank's queries at positions a..a+L-1 go in after a rows of zeros and
    their keys are the first a+L: the zero rows' outputs are dropped, and
    their gradients are zero."""
    b, l, d = z.shape
    h, hd, t, m = cfg.n_heads, cfg.head_dim, lay.tp, lay.model_rank
    s = l * t
    wq = lay.weight(params["wq"], specs["wq"])
    wk = lay.weight(params["wk"], specs["wk"])
    wv = lay.weight(params["wv"], specs["wv"])
    wo = lay.weight(params["wo"], specs["wo"])
    zf = comm.gather_along(z, lay.model_group, 1)
    pos = torch.arange(s, device=z.device).expand(b, s)
    if lay.mode == "sharded":
        if lay.kv_repeat > 1:
            kv_l = cfg.n_kv_heads * lay.kv_repeat // t
            wk, wv = (w.repeat_interleave(lay.kv_repeat, dim=1)
                      .narrow(1, m * kv_l, kv_l) for w in (wk, wv))
        h_l, kv_l = wq.shape[1], wk.shape[1]
        q = (zf @ wq.reshape(d, h_l * hd)).reshape(b, s, h_l, hd)
        k = (zf @ wk.reshape(d, kv_l * hd)).reshape(b, s, kv_l, hd)
        v = (zf @ wv.reshape(d, kv_l * hd)).reshape(b, s, kv_l, hd)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        out = chunked_prefill_attention(_group_query(q, kv_l), k, v,
                                        softcap=cfg.attn_softcap)
        y = out.reshape(b, s, h_l * hd) @ wo.reshape(h_l * hd, d)
        y = comm.reduce_scatter_along(y, lay.model_group, 1)
        return (y, _prompt_kv(k, v, lay)) if kv_out else y
    kv = cfg.n_kv_heads
    a = m * l
    q = (z @ wq.reshape(d, h * hd)).reshape(b, l, h, hd)
    k = (zf[:, :a + l] @ wk.reshape(d, kv * hd)).reshape(b, a + l, kv, hd)
    v = (zf[:, :a + l] @ wv.reshape(d, kv * hd)).reshape(b, a + l, kv, hd)
    q = apply_rope(q, pos[:, a:a + l], cfg.rope_theta)
    k = apply_rope(k, pos[:, :a + l], cfg.rope_theta)
    if a:
        q = torch.cat([q.new_zeros((b, a, h, hd)), q], dim=1)
    out = chunked_prefill_attention(_group_query(q, kv), k, v,
                                    softcap=cfg.attn_softcap)[:, a:]
    y = out.reshape(b, l, h * hd) @ wo.reshape(h * hd, d)
    return (y, _prompt_kv(k[:, a:], v[:, a:], lay)) if kv_out else y


def _prompt_kv(k: torch.Tensor, v: torch.Tensor, lay):
    """The prompt's true-head (k, v), each (B, S, KV, hd), from this rank's
    block of them, in one gather over ``model``: its heads over the whole
    sequence in "sharded" mode (every rank's heads in rank order, then
    every ``kv_repeat``-th, the true heads the repeat copied), its own
    positions on every head in "replicated" mode."""
    if lay.mode == "replicated":
        n = k.shape[2]
        kv = comm.all_gather_cat(torch.cat([k, v], dim=2), lay.model_group,
                                 1)
        return kv[:, :, :n], kv[:, :, n:]
    k, v = _gather_heads([k, v], lay)
    r = lay.kv_repeat
    return (k[:, :, ::r], v[:, :, ::r]) if r > 1 else (k, v)


def _gather_heads(parts: list, lay) -> list:
    """Each (B, S, n_i, hd) of ``parts`` as (B, S, tp·n_i, hd), every model
    rank's heads in rank order: one `all_gather` over ``model`` for
    all."""
    split = [t.shape[2] for t in parts]
    g = comm.all_gather_cat(torch.cat(parts, dim=2), lay.model_group, 2)
    g = g.unflatten(2, (lay.tp, sum(split)))
    return [t.flatten(2, 3) for t in g.split(split, dim=3)]


# ---------------------------------------------------------------------------
# context-parallel decode
# ---------------------------------------------------------------------------

def decode_partials(q: torch.Tensor, k_blk: torch.Tensor,
                    v_blk: torch.Tensor, first: int, length, *,
                    softcap: float = 0.0) -> torch.Tensor:
    """One block's share of `decode_attention`: q (B, 1, KV, G, hd); the
    block's cache slots k_blk, v_blk (B, n, KV, hd), slot j at position
    ``first`` + j; ``length`` valid positions in all. Returns float32
    (B, 1, KV, G, hd + 2): the unnormalised output acc, the block's
    running max m and its sum l (`combine_partials`). Scores are softcapped
    before the max and masked to NEG_INF past the length, as
    `decode_attention` does, so a block that holds no valid slot has m =
    NEG_INF and l = n, and its weight in the combine underflows to 0."""
    n = k_blk.shape[1]
    sc = torch.einsum("bqkgh,bskh->bkgqs", q.to(torch.float32),
                      k_blk.to(torch.float32)) * (q.shape[-1] ** -0.5)
    sc = _softcap(sc, softcap)
    valid = torch.arange(first, first + n, device=q.device) < length
    sc = torch.where(valid, sc, NEG_INF)
    m = sc.amax(-1, keepdim=True)                       # (B, KV, G, 1, 1)
    p = torch.exp(sc - m)
    acc = torch.einsum("bkgqs,bskh->bqkgh", p, v_blk.to(torch.float32))
    stats = torch.cat([m, p.sum(-1, keepdim=True)], dim=-1)   # (B,KV,G,1,2)
    return torch.cat([acc, stats.permute(0, 3, 1, 2, 4)], dim=-1)


def combine_partials(parts: torch.Tensor) -> torch.Tensor:
    """The softmax-weighted output from the blocks' `decode_partials`
    stacked along dim 0 (n, B, 1, KV, G, hd + 2): each block's acc and sum
    rescaled by exp(m - the largest m) and added in block order, then the
    acc over the sum. float32 (B, 1, KV, G, hd)."""
    m = parts[..., -2:-1]
    w = torch.exp(m - m.amax(0))
    acc, den = parts[0, ..., :-2] * w[0], parts[0, ..., -1:] * w[0]
    for i in range(1, parts.shape[0]):
        acc = acc + parts[i, ..., :-2] * w[i]
        den = den + parts[i, ..., -1:] * w[i]
    return acc / den


def decode_block_sharded(params: dict, cfg, x: torch.Tensor, lay,
                         specs: dict, cache, layer: int,
                         pos: int) -> torch.Tensor:
    """The one-token attention block on a rank of a mesh, context-parallel
    over the sequence-sharded cache: ``x`` (B, 1, D) the normed residual,
    the same on every model rank; ``cache`` the rank's (k, v) stacks (L,
    B, S_max/tp, KV, hd), slots m·S_max/tp onward on model rank m, the
    true kv heads. Returns the block's output (B, 1, D), the same on every
    model rank.

    Every rank needs every query head: "sharded" mode gathers the rank's
    query heads (and its kv heads, when they are sharded) over ``model``
    in one `all_gather`; "replicated" mode computes them all. The rank
    that owns slot ``pos`` writes the new token's k and v there. Each rank
    takes its slots' share (`decode_partials`), the shares of every rank
    come together in one `all_gather` and every rank combines them in rank
    order (`combine_partials`), so all get the same bits. Then ``wo``: the
    rank's heads and an all-reduce over ``model`` ("sharded"), or the
    whole product ("replicated")."""
    b, _, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    w = {n: lay.weight(params[n], specs[n]) for n in ("wq", "wk", "wv",
                                                      "wo")}
    q = (x @ w["wq"].reshape(d, -1)).reshape(b, 1, -1, hd)
    k = (x @ w["wk"].reshape(d, -1)).reshape(b, 1, -1, hd)
    v = (x @ w["wv"].reshape(d, -1)).reshape(b, 1, -1, hd)
    h_l = q.shape[2]
    if k.shape[2] < kv:
        q, k, v = _gather_heads([q, k, v], lay)
    elif h_l < h:               # the kv weights whole on every rank
        q, = _gather_heads([q], lay)
    positions = torch.full((b, 1), pos, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    k_stack, v_stack = cache
    sb = k_stack.shape[2]
    first = lay.model_rank * sb
    if first <= pos < first + sb:
        k_stack[layer, :, pos - first] = k[:, 0]
        v_stack[layer, :, pos - first] = v[:, 0]
    part = decode_partials(_group_query(q, kv), k_stack[layer],
                           v_stack[layer], first, pos + 1,
                           softcap=cfg.attn_softcap)
    parts = comm.all_gather_cat(part[None], lay.model_group, 0)
    out = combine_partials(parts).to(x.dtype).reshape(b, 1, h, hd)
    if h_l < h:
        out = out[:, :, lay.model_rank * h_l:(lay.model_rank + 1) * h_l]
    y = out.reshape(b, 1, h_l * hd) @ w["wo"].reshape(h_l * hd, d)
    return comm.reduce_from_group(y, lay.model_group) if h_l < h else y
