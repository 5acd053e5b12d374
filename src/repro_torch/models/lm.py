"""LM serving steps and KV caches.

Counterpart of the serving half of `repro.models.lm` for the `attn_mlp`
layer kind: `init_caches` and `extend_caches` (KV caches only; SSM caches
come with the SSM slice), `prefill` and `decode_step`. The KV caches keep
the JAX package's layout, a (k, v) pair of (L, B, S_max, KV, hd) tensors,
and decode writes each new token into them in place at its position.
Serving prefills straight into S_max slots (`prefill(..., s_max=...)`), so
no exact-length pair is made and copied by `extend_caches`. The
training loss (`chunked_ce_loss`, `lm_loss`) comes with LM training.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer


def init_caches(cfg, batch_size: int, s_max: int, dtype=None,
                device="cuda") -> dict:
    """Preallocated decode caches sized for an s_max-token context."""
    transformer.require_attn_mlp(cfg)
    dev = resolve_device(device)
    dtype = dtype or transformer.torch_dtype(cfg)
    shape = (cfg.n_layers, batch_size, s_max, cfg.n_kv_heads, cfg.head_dim)
    return {"kv": (torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev))}


def extend_caches(cfg, caches: dict, s_max: int) -> dict:
    """Prefill caches (exact prompt length) padded with zeros out to s_max
    slots, the decode layout."""
    transformer.require_attn_mlp(cfg)

    def pad(t):
        if t.shape[2] > s_max:
            raise ValueError(f"extend_caches: the prompt holds {t.shape[2]} "
                             f"positions, more than s_max={s_max}")
        out = t.new_zeros((*t.shape[:2], s_max, *t.shape[3:]))
        out[:, :, :t.shape[2]] = t
        return out

    k, v = caches["kv"]
    return {**caches, "kv": (pad(k), pad(v))}


def prefill(params, cfg, batch: dict, s_max: int | None = None):
    """Prefill: returns (last-position logits, caches over the prompt). With
    s_max the caches come in the decode layout, s_max slots with the
    prompt written into the first ones (what `extend_caches` makes of the
    exact-length caches, without their copy)."""
    hidden, caches = transformer.forward(
        params, cfg, batch["tokens"], prefix_embed=batch.get("prefix_embed"),
        s_max=s_max)
    logits = transformer.logits_from_hidden(params, cfg, hidden[:, -1:, :])
    return logits, caches


def decode_step(params, cfg, token, caches: dict, pos: int):
    """One-token decode against preallocated caches at position `pos`; the
    caches are updated in place and returned."""
    hidden, new_caches = transformer.forward(
        params, cfg, token, caches=caches, pos0=pos)
    return transformer.logits_from_hidden(params, cfg, hidden), new_caches
