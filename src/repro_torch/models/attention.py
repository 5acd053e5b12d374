"""GQA/MQA attention with RoPE: flash prefill, KV-cache decode.

Counterpart of `repro.models.attention`. On one device the JAX package's
`head_sharding` gives `("replicated", 1)`, so kv heads are never repeated;
`attention_block_sharded` is the training block on a rank of a mesh
(`sharding.spmd`), in both of `head_sharding`'s modes. Prefill attention goes through the hand-written
`flash_attention` kernel (`kernels/flash_attn.py`, its model-layout wrapper
`flash_attention_bshd`), which computes what the JAX package's
`chunked_prefill_attention` computes; decode attends over the
whole preallocated cache with a position mask in plain PyTorch, as the JAX
package does outside any Pallas kernel.
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
                            specs: dict) -> torch.Tensor:
    """The training attention block on a rank of a mesh: ``z`` (B, S/tp,
    D) this rank's sequence block of the normed residual; returns its
    block of the block's output, (B, S/tp, D). ``specs`` lays out
    ``params`` (one layer's).

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
        return comm.reduce_scatter_along(y, lay.model_group, 1)
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
    return out.reshape(b, l, h * hd) @ wo.reshape(h * hd, d)
