"""LM serving runtime: batched prefill + decode loop with preallocated caches.

Counterpart of `repro.runtime.lm_serve`. `generate` drives a full prefill
and an N-token decode; greedy decoding picks the same tokens as the JAX
package on the same parameters. Sampling draws from an explicit
`torch.Generator` in place of the JAX key (torch cannot replay
`jax.random`), so the same generator state reproduces the same sequence.
"""
from __future__ import annotations

import torch

from repro_torch.models import lm


def make_prefill_step(cfg, s_max: int | None = None):
    """Prefill: (params, batch) -> (logits, caches); with s_max the caches
    have s_max slots, ready for decode."""
    def prefill_step(params, batch):
        return lm.prefill(params, cfg, batch, s_max=s_max)
    return prefill_step


def make_serve_step(cfg):
    """One-token decode: (params, token (B, 1), caches, pos) ->
    (logits, caches)."""
    def serve_step(params, token, caches, pos):
        return lm.decode_step(params, cfg, token, caches, pos)
    return serve_step


def generate(params, cfg, prompt_batch: dict, n_tokens: int, s_max: int,
             greedy: bool = True, generator: torch.Generator | None = None,
             temperature: float = 1.0) -> torch.Tensor:
    """Prefill the prompt then decode exactly `n_tokens` autoregressively.

    greedy=True: argmax decoding (`generator` ignored). greedy=False:
    temperature sampling with `torch.multinomial` over `generator`, which is
    required. Returns (B, n_tokens) int32; `n_tokens=0` returns (B, 0).
    """
    tokens = prompt_batch["tokens"]
    if n_tokens <= 0:
        return torch.zeros((tokens.shape[0], 0), dtype=torch.int32,
                           device=tokens.device)
    if not greedy and generator is None:
        raise ValueError("greedy=False sampling requires a torch.Generator")

    def pick(logits):
        lg = logits[:, -1, :cfg.vocab_size]
        if greedy:
            return lg.argmax(dim=-1).to(torch.int32)[:, None]
        lg = lg.to(torch.float32) / max(temperature, 1e-6)
        return torch.multinomial(torch.softmax(lg, dim=-1), 1,
                                 generator=generator).to(torch.int32)

    logits, caches = make_prefill_step(cfg, s_max)(params, prompt_batch)
    prefix = prompt_batch.get("prefix_embed")
    prompt_len = tokens.shape[1] + (prefix.shape[1] if prefix is not None
                                    else 0)
    serve_step = make_serve_step(cfg)
    tok = pick(logits)
    out = [tok]
    for i in range(n_tokens - 1):
        logits, caches = serve_step(params, tok, caches, prompt_len + i)
        tok = pick(logits)
        out.append(tok)
    return torch.cat(out, dim=1)
