"""Model assembly: embeddings, the layer stack, final norm, logits.

Counterpart of `repro.models.transformer` for the `attn_mlp` layer kind
(families `dense`, `audio` and `vlm`): [attention + MLP] x L. Parameters are
a dict tree like the JAX package's, with every per-layer tensor stacked on a
leading layer axis; layer l reads views of row l. The layers run in a Python
loop (the JAX package scans them). Prefill writes each layer's (k, v) into
one (L, B, S, KV, hd) pair of caches; decode writes the new token into the
given caches in place. The `moe`, `ssm` and `hybrid` kinds raise
`NotImplementedError`.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention, lm_mlp
from repro_torch.models.common import apply_norm, init_norm, normal_init


def layer_kind(cfg) -> str:
    if cfg.family == "moe":
        return "attn_moe"
    if cfg.family in ("ssm", "hybrid"):
        return "ssm"
    return "attn_mlp"


def require_attn_mlp(cfg) -> None:
    """Raise unless ``cfg``'s layers are of the ported `attn_mlp` kind."""
    if layer_kind(cfg) != "attn_mlp":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.family} layers ({layer_kind(cfg)}) are not "
            f"ported yet: ROADMAP.md Queue 1 item 13")


def torch_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(seed: int, cfg, dtype: torch.dtype | None = None,
                device="cuda") -> dict:
    """Random parameters from a `torch.Generator` seeded with ``seed`` on
    ``device`` (float32 draws, then cast to ``dtype``, default the
    config's)."""
    require_attn_mlp(cfg)
    dev = resolve_device(device)
    dtype = dtype or torch_dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    vp, d, lead = cfg.padded_vocab, cfg.d_model, (cfg.n_layers,)
    params = {
        "embed": normal_init(gen, (vp, d), 0.02, dtype),
        "final_norm": init_norm(cfg, dtype, dev),
        "layers": {
            "ln1": init_norm(cfg, dtype, dev, lead),
            "attn": attention.init_attention(gen, cfg, dtype, lead),
            "ln2": init_norm(cfg, dtype, dev, lead),
            "ffn": lm_mlp.init_mlp(gen, cfg, dtype, lead),
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(gen, (vp, d), d ** -0.5, dtype)
    return params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attn_mlp_block(p, cfg, x, positions, *, cache=None, cache_pos=None,
                    cache_layer=None):
    """Returns (x_out, new_kv)."""
    h, new_kv = attention.attention_block(
        p["attn"], cfg, apply_norm(p["ln1"], x, cfg.norm), positions,
        cache=cache, cache_pos=cache_pos, cache_layer=cache_layer)
    x = x + h
    z = apply_norm(p["ln2"], x, cfg.norm)
    return x + lm_mlp.mlp_block(p["ffn"], cfg, z), new_kv


def _tree_slice(tree, i):
    if isinstance(tree, dict):
        return {k: _tree_slice(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward(params, cfg, tokens, *, prefix_embed=None, caches=None,
            pos0=None, s_max=None):
    """Shared forward for prefill (caches=None: fresh caches are returned,
    of s_max slots with the prompt in the first S, or of exactly S when
    s_max is None) and decode (caches given: one-token step at position
    pos0, caches updated in place).

    tokens (B, S_text) integer; prefix_embed (B, P, D) for vlm.
    Returns (hidden (B, S, D), new_caches); the JAX package's third output,
    the MoE load-balance loss, comes with the MoE layers.
    """
    require_attn_mlp(cfg)
    x = params["embed"][tokens]                    # gather (B, S_text, D)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if prefix_embed is not None:
        x = torch.cat([prefix_embed.to(x.dtype), x], dim=1)
    b, s, _ = x.shape

    decoding = caches is not None
    if decoding:
        positions = torch.full((b, 1), pos0, device=x.device)
        kv = caches["kv"]
        for layer in range(cfg.n_layers):
            p = _tree_slice(params["layers"], layer)
            x, kv = _attn_mlp_block(p, cfg, x, positions, cache=kv,
                                    cache_pos=pos0, cache_layer=layer)
    else:
        slots = s if s_max is None else s_max
        if slots < s:
            raise ValueError(f"forward: the prompt holds {s} positions, more "
                             f"than s_max={s_max}")
        positions = torch.arange(s, device=x.device).expand(b, s)
        shape = (cfg.n_layers, b, slots, cfg.n_kv_heads, cfg.head_dim)
        kv = (x.new_zeros(shape), x.new_zeros(shape))
        for layer in range(cfg.n_layers):
            p = _tree_slice(params["layers"], layer)
            x, (k, v) = _attn_mlp_block(p, cfg, x, positions)
            kv[0][layer, :, :s] = k
            kv[1][layer, :, :s] = v

    x = apply_norm(params["final_norm"], x, cfg.norm)
    return x, {"kv": kv}


def logits_from_hidden(params, cfg, hidden):
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return hidden @ table.T
