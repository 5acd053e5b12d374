"""LM serving runtime: batched prefill + decode loop with preallocated caches.

Counterpart of `repro.runtime.lm_serve`. `generate` drives a full prefill
and an N-token decode; greedy decoding picks the same tokens as the JAX
package on the same parameters. Sampling draws from an explicit
`torch.Generator` in place of the JAX key (torch cannot replay
`jax.random`), so the same generator state reproduces the same sequence.

With ``rules`` (`sharding.rules.MeshRules` bound to the `DeviceMesh` of
the ranks, `launch.mesh.rules_for`) each rank serves its batch rows with
its blocks of the parameters (`sharding.params.param_specs`) and of the
caches (`sharding.params.cache_blocks`: the KV caches' slots over
``model``, context-parallel decode) and gets back its rows' tokens, the
same on every model rank.
"""
from __future__ import annotations

import torch

from repro_torch.models import lm


def _layout_now(cfg, rules) -> None:
    """Build the rank's layout (its groups and spec trees) when the step is
    made, as `runtime.train.make_train_step` does, so that a step's first
    call does no set-up (and `launch.step_analysis` counts the step
    alone)."""
    if rules is not None:
        from repro_torch.sharding.spmd import layout

        layout(cfg, rules)


def make_prefill_step(cfg, s_max: int | None = None, rules=None):
    """Prefill: (params, batch) -> (logits, caches); with s_max the caches
    have s_max slots, ready for decode (with ``rules``: a rank's blocks,
    `models.lm.prefill`)."""
    _layout_now(cfg, rules)

    def prefill_step(params, batch):
        return lm.prefill(params, cfg, batch, s_max=s_max, rules=rules)
    return prefill_step


def make_serve_step(cfg, rules=None):
    """One-token decode: (params, token (B, 1), caches, pos) ->
    (logits, caches)."""
    _layout_now(cfg, rules)

    def serve_step(params, token, caches, pos):
        return lm.decode_step(params, cfg, token, caches, pos, rules=rules)
    return serve_step


def generate(params, cfg, prompt_batch: dict, n_tokens: int, s_max: int,
             greedy: bool = True, generator: torch.Generator | None = None,
             temperature: float = 1.0, rules=None) -> torch.Tensor:
    """Prefill the prompt then decode exactly `n_tokens` autoregressively.

    greedy=True: argmax decoding (`generator` ignored). greedy=False:
    temperature sampling with `torch.multinomial` over `generator`, which is
    required. Returns (B, n_tokens) int32; `n_tokens=0` returns (B, 0).

    With ``rules``: ``params`` are this rank's blocks and ``prompt_batch``
    its rows (every row where the batch does not divide over the batch
    axes, `sharding.params.serve_rows`); every model rank of those rows
    picks from the same gathered logits, so they return the same tokens (a
    sampling caller gives each of them a generator in the same state).
    s_max must divide over the model ranks.
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

    logits, caches = make_prefill_step(cfg, s_max, rules)(params,
                                                          prompt_batch)
    prefix = prompt_batch.get("prefix_embed")
    prompt_len = tokens.shape[1] + (prefix.shape[1] if prefix is not None
                                    else 0)
    serve_step = make_serve_step(cfg, rules)
    tok = pick(logits)
    out = [tok]
    for i in range(n_tokens - 1):
        logits, caches = serve_step(params, tok, caches, prompt_len + i)
        tok = pick(logits)
        out.append(tok)
    return torch.cat(out, dim=1)
