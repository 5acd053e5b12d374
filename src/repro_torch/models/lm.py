"""LM head: the chunked CE loss, decode caches and the serving steps.

Counterpart of `repro.models.lm` for every layer kind (`attn_mlp`,
`attn_moe`, `ssm`): the training loss (`chunked_ce_loss`, `lm_loss`, over
`transformer.forward_train`), `init_caches` and `extend_caches`, `prefill`
and `decode_step`.

The CE loss runs over sequence chunks of `cfg.loss_chunk` positions
(halved until they divide S), each chunk under a non-reentrant
`torch.utils.checkpoint`, so the backward rebuilds one chunk's (B, chunk,
vocab) float32 logits at a time and no chunk's logits stay saved: at
llama3.2-3b's vocab the whole sequence's would take 8 GB at B=2 x 4096.
The target's log-probability is the JAX package's iota-compare-reduce
(`sum(where(iota == target, logits, 0))`), taken as a gather: a sum of one
value and zeros is that value, bit for bit, and its gradient is the same
one-hot scatter, without a (B, chunk, vocab) mask.

The caches keep the JAX package's layout: a
(k, v) pair of (L, B, S_max, KV, hd) tensors for attention layers; a
(conv (L, B, K-1, C), state (L, B, NH, HD, N)) pair for SSM layers, the
states float32 in every model dtype; and for the hybrid, a (k, v) pair of (n_super, B, S_max,
KV, hd), one slot a super-block's shared block. Decode writes each new
token into them in place at its position. Serving prefills straight into
the decode layout (`prefill(..., s_max=...)`), so no exact-length caches
are made and copied by `extend_caches`.

With ``rules`` (a rank of a mesh) `prefill`, `decode_step` and
`init_caches` take and give a rank's blocks: the caches in
`sharding.params.cache_blocks`'s layout, the logits the whole row of the
vocab-parallel head, gathered over ``model``.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import comm
from repro_torch.device import resolve_device
from repro_torch.models import transformer


def _ce_chunk(hc, table, tc, mc):
    """sum((logsumexp(logits) - logits[target]) * mask) over one chunk."""
    logits = (hc @ table.T).to(torch.float32)          # (B, cs, V)
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, tc[..., None].to(torch.int64))[..., 0]
    return torch.sum((logz - ll) * mc)


def _ce_chunk_sharded(hc, table, tc, mc, lay):
    """`_ce_chunk` with the table's rows (the vocabulary) sharded over
    ``model``: the log-sum-exp's max and sum reduced over ``model``, the
    target's logit taken on the rank that holds its row."""
    group, rows = lay.model_group, table.shape[0]
    logits = (hc @ table.T).to(torch.float32)          # (B, cs, V/tp)
    top = comm.all_reduce_max(logits.detach().amax(-1), group)
    se = comm.reduce_from_group(torch.exp(logits - top[..., None]).sum(-1),
                                group)
    logz = torch.log(se) + top
    local = tc.to(torch.int64) - lay.model_rank * rows
    hit = (local >= 0) & (local < rows)
    ll = logits.gather(-1, local.clamp(0, rows - 1)[..., None])[..., 0]
    ll = comm.reduce_from_group(torch.where(hit, ll, 0.0), group)
    return torch.sum((logz - ll) * mc)


def chunked_ce_loss(params, cfg, hidden, targets, mask, rules=None):
    """hidden (B, S, D); targets/mask (B, S). Returns (mean_loss, n_tokens),
    both float32 0-dim: the masked token losses summed chunk by chunk in
    sequence order, over max(n_tokens, 1).

    With ``rules`` (a rank of a mesh: ``hidden`` its batch rows, whole
    along the sequence, the table its rows of the vocabulary) the logits
    are vocab-parallel (`_ce_chunk_sharded`), n_tokens is the count summed
    over the batch axes, and mean_loss is this rank's share: its rows'
    losses over that count, which the shares of the batch axes' ranks sum
    to the mean (not a mean of per-rank means: ranks may count unequally)."""
    s = hidden.shape[1]
    key = "embed" if cfg.tie_embeddings else "lm_head"
    table = params[key]
    lay = None
    if rules is not None:
        from repro_torch.sharding.spmd import layout

        lay = layout(cfg, rules)
        table = lay.weight(table, lay.specs[key])
    cs = min(cfg.loss_chunk, s)
    while s % cs != 0:
        cs //= 2
    cs = max(cs, 1)
    maskf = mask.to(torch.float32)
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    remat = torch.is_grad_enabled()
    fn = _ce_chunk if lay is None else \
        (lambda *a: _ce_chunk_sharded(*a, lay))
    for c0 in range(0, s, cs):
        args = (hidden[:, c0:c0 + cs], table, targets[:, c0:c0 + cs],
                maskf[:, c0:c0 + cs])
        part = (checkpoint(fn, *args, use_reentrant=False) if remat
                else fn(*args))
        loss_sum = loss_sum + part
        cnt = cnt + args[3].sum()
    if lay is not None:
        for group in lay.batch_groups:
            cnt = comm.all_reduce_sum(cnt, group)
    return loss_sum / torch.clamp(cnt, min=1.0), cnt


def lm_loss(params, cfg, batch: dict, rules=None, aux_weight: float = 0.01):
    """Causal LM loss. batch: tokens (B, S) [+ prefix_embed (B, P, D)].
    Returns (loss, {"ce_loss", "aux_loss", "tokens"}): loss the CE over the
    text positions (hidden[i] predicts tokens[i + 1]) plus aux_weight times
    the MoE load-balance loss over the layer count. With ``rules`` the
    batch is this rank's rows and the CE its share (`chunked_ce_loss`);
    the aux is averaged over every rank and the loss holds this rank's
    share of it (`_aux_over_ranks`)."""
    tokens = batch["tokens"]
    prefix = batch.get("prefix_embed")
    hidden, aux = transformer.forward_train(params, cfg, tokens,
                                            prefix_embed=prefix, rules=rules)
    if prefix is not None:
        hidden = hidden[:, prefix.shape[1]:, :]   # text positions only
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                        dim=1)
    mask = torch.cat([torch.ones_like(tokens[:, 1:]),
                      torch.zeros_like(tokens[:, :1])], dim=1)
    loss, cnt = chunked_ce_loss(params, cfg, hidden, targets, mask, rules)
    share = aux
    if rules is not None and cfg.n_experts:
        aux, share = _aux_over_ranks(aux, cfg, rules)
    return loss + aux_weight * share / max(cfg.n_layers, 1), {
        "ce_loss": loss, "aux_loss": aux, "tokens": cnt}


def _aux_over_ranks(aux, cfg, rules):
    """(mean, share) of the ranks' MoE losses ``aux`` (each over its own
    tokens): the mean over every rank of the mesh (the JAX package's
    ``pmean`` over every axis) and this rank's share of it in the loss, the
    mean over the batch ranks' count, so the shares of the batch axes sum
    to it as the CE's do. Backward, each rank's own aux gets the loss's
    gradient over the rank count, the gradient of the mean with respect to
    that rank's term: summed from every rank's share over the batch axes
    (`comm.copy_to_group`) after the forward's sums (`comm.reduce_from_group`,
    identity backward)."""
    from repro_torch.sharding.rules import mesh_axes
    from repro_torch.sharding.spmd import layout

    lay = layout(cfg, rules)
    sizes = mesh_axes(rules.mesh)
    for axis in sizes:
        aux = comm.reduce_from_group(aux, rules.mesh.get_group(axis))
    for group in lay.batch_groups:
        aux = comm.copy_to_group(aux, group)
    aux = aux / math.prod(sizes.values())
    return aux, aux / math.prod(sizes[a] for a in rules.batch)


def init_caches(cfg, batch_size: int, s_max: int, rules=None, dtype=None,
                device="cuda") -> dict:
    """Preallocated decode caches sized for an s_max-token context. With
    ``rules`` (bound to the mesh of the ranks), this rank's blocks of
    them for a global batch of ``batch_size`` rows
    (`sharding.params.cache_blocks`'s layout): its rows, or every row
    where the batch does not divide over the batch axes
    (`sharding.params.serve_rows`); an s_max that does not divide over
    the model ranks is refused."""
    dev = resolve_device(device)
    dtype = dtype or transformer.torch_dtype(cfg)
    if rules is None:
        return transformer.empty_caches(cfg, batch_size, s_max, dtype, dev)
    from repro_torch.sharding.params import check_serve, serve_rows

    check_serve(rules, rules.mesh, s_max=s_max)
    return transformer.empty_caches(
        cfg, serve_rows(rules, rules.mesh, batch_size), s_max, dtype, dev,
        rules.tp)


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


def prefill(params, cfg, batch: dict, s_max: int | None = None,
            rules=None):
    """Prefill: returns (last-position logits, caches over the prompt). With
    s_max the caches come in the decode layout, s_max slots with the
    prompt written into the first ones (what `extend_caches` makes of the
    exact-length caches, without their copy). The MoE load-balance loss
    is dropped, as the JAX package's prefill drops it.

    With ``rules`` (a rank of a mesh): ``params`` are the rank's blocks
    and ``batch`` its rows; the caches are its blocks in the decode
    layout (s_max slots, default the prompt's length), and the logits
    its rows' whole (B, 1, padded vocab), the same on every model
    rank."""
    hidden, caches, _ = transformer.forward(
        params, cfg, batch["tokens"], prefix_embed=batch.get("prefix_embed"),
        s_max=s_max, rules=rules)
    if rules is not None:
        from repro_torch.sharding.spmd import layout

        lay = layout(cfg, rules)
        # the last position lives on the last model rank
        last = comm.all_gather_cat(hidden[:, -1:], lay.model_group, 1)
        return _logits_sharded(params, lay, last[:, -1:]), caches
    logits = transformer.logits_from_hidden(params, cfg, hidden[:, -1:, :])
    return logits, caches


def decode_step(params, cfg, token, caches: dict, pos: int, rules=None):
    """One-token decode against preallocated caches at position `pos`; the
    caches are updated in place and returned. With ``rules``: the rank's
    blocks and rows, as `prefill` takes them."""
    hidden, new_caches, _ = transformer.forward(
        params, cfg, token, caches=caches, pos0=pos, rules=rules)
    if rules is not None:
        from repro_torch.sharding.spmd import layout

        return _logits_sharded(params, layout(cfg, rules), hidden), \
            new_caches
    return transformer.logits_from_hidden(params, cfg, hidden), new_caches


@torch.no_grad()
def _logits_sharded(params, lay, hidden):
    """The vocab-parallel head: ``hidden`` (B, 1, D) the same on every
    model rank, times the rank's rows of the table, gathered over
    ``model`` into the whole (B, 1, padded vocab) row."""
    key = "embed" if lay.cfg.tie_embeddings else "lm_head"
    logits = hidden @ params[key].T
    return comm.all_gather_cat(logits, lay.model_group, 2)
