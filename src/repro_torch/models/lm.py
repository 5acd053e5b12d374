"""LM serving steps and decode caches.

Counterpart of the serving half of `repro.models.lm` for every layer kind
(`attn_mlp`, `attn_moe`, `ssm`): `init_caches` and `extend_caches`,
`prefill` and `decode_step`. The caches keep the JAX package's layout: a
(k, v) pair of (L, B, S_max, KV, hd) tensors for attention layers; a
(conv (L, B, K-1, C), state (L, B, NH, HD, N)) pair for SSM layers, the
states float32 in every model dtype; and for the hybrid, a (k, v) pair of (n_super, B, S_max,
KV, hd), one slot a super-block's shared block. Decode writes each new
token into them in place at its position. Serving prefills straight into
the decode layout (`prefill(..., s_max=...)`), so no exact-length caches
are made and copied by `extend_caches`. The training loss
(`chunked_ce_loss`, `lm_loss`) comes with LM training.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer


def init_caches(cfg, batch_size: int, s_max: int, dtype=None,
                device="cuda") -> dict:
    """Preallocated decode caches sized for an s_max-token context."""
    dev = resolve_device(device)
    dtype = dtype or transformer.torch_dtype(cfg)
    return transformer.empty_caches(cfg, batch_size, s_max, dtype, dev)


def extend_caches(cfg, caches: dict, s_max: int) -> dict:
    """Prefill caches (exact prompt length; the hybrid's SSM caches grouped
    by super-block) in the decode layout: KV padded with zeros out to s_max
    slots, the hybrid's SSM caches one (n_layers, ...) stack."""

    def pad(t):
        if t.shape[2] > s_max:
            raise ValueError(f"extend_caches: the prompt holds {t.shape[2]} "
                             f"positions, more than s_max={s_max}")
        out = t.new_zeros((*t.shape[:2], s_max, *t.shape[3:]))
        out[:, :, :t.shape[2]] = t
        return out

    out = dict(caches)
    for key in ("kv", "shared_kv"):
        if key in out:
            out[key] = tuple(pad(t) for t in out[key])
    if "ssm_main" in out:  # hybrid prefill layout -> flat decode layout
        main = tuple(t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])
                     for t in out.pop("ssm_main"))
        tail = out.pop("ssm_tail", None)
        out["ssm"] = main if tail is None else tuple(
            torch.cat([m, t], dim=0) for m, t in zip(main, tail))
    return out


def prefill(params, cfg, batch: dict, s_max: int | None = None):
    """Prefill: returns (last-position logits, caches over the prompt). With
    s_max the caches come in the decode layout, s_max slots with the
    prompt written into the first ones (what `extend_caches` makes of the
    exact-length caches, without their copy). The MoE load-balance loss
    is dropped, as the JAX package's prefill drops it."""
    hidden, caches, _ = transformer.forward(
        params, cfg, batch["tokens"], prefix_embed=batch.get("prefix_embed"),
        s_max=s_max)
    logits = transformer.logits_from_hidden(params, cfg, hidden[:, -1:, :])
    return logits, caches


def decode_step(params, cfg, token, caches: dict, pos: int):
    """One-token decode against preallocated caches at position `pos`; the
    caches are updated in place and returned."""
    hidden, new_caches, _ = transformer.forward(
        params, cfg, token, caches=caches, pos0=pos)
    return transformer.logits_from_hidden(params, cfg, hidden), new_caches
