"""GQA/MQA attention with RoPE: flash prefill, KV-cache decode.

Counterpart of `repro.models.attention` on one device (no sharding: the
JAX package's `head_sharding` gives `("replicated", 1)` there, so kv heads
are never repeated). Prefill attention goes through the hand-written
`flash_attention` kernel (`kernels/flash_attn.py`, its model-layout wrapper
`flash_attention_bshd`), which computes what the JAX package's
`chunked_prefill_attention` computes; decode attends over the
whole preallocated cache with a position mask in plain PyTorch, as the JAX
package does outside any Pallas kernel.
"""
from __future__ import annotations

import torch

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
