"""Model assembly: embeddings, the layer stack, final norm, logits.

Counterpart of `repro.models.transformer` on one device, for all three
layer kinds: `attn_mlp` (families `dense`, `audio` and `vlm`: [attention +
MLP] x L), `attn_moe` (family `moe`: [attention + MoE] x L, with the
load-balance loss summed over the layers) and `ssm` (family `ssm`:
[mamba2] x L; family `hybrid`, zamba2: super-blocks of `shared_attn_every`
mamba2 layers, each followed by one of `n_shared_blocks` shared attention
+ MLP blocks in turn, then a tail of plain mamba2 layers). Parameters are a
dict tree like the JAX package's, with every per-layer tensor stacked on a
leading layer axis (the hybrid's shared blocks on their own); layer l reads
views of row l. The layers run in a Python loop (the JAX package scans
them). Prefill writes each layer's caches into stacked tensors: (L, B, S,
KV, hd) k and v pairs, (L, B, K-1, C) conv and (L, B, NH, HD, N) float32
SSM states, and the hybrid's (n_super, B, S, KV, hd) shared-block pair;
decode updates the given caches in place. With ``rules``, `forward` serves
on a rank of a mesh (`_forward_sharded`: the sharded blocks, the caches a
rank's blocks).

Training runs `forward_train`, which writes no cache (a cache copy under
autograd would keep every layer's k and v alive) and, when `cfg.remat`,
rematerialises each layer (the hybrid: each super-block, and each tail
layer) with `torch.utils.checkpoint` (non-reentrant): only the layer inputs
stay saved, as under the JAX package's `jax.checkpoint(...,
nothing_saveable)` scan bodies. Its per-layer parameters are the stacked
tensors split by one `torch.unbind` each, so the backward stacks each
leaf's gradient once instead of adding a zero-padded full-size gradient a
layer.
"""
from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import comm
from repro_torch.device import resolve_device
from repro_torch.models import attention, lm_mlp, moe, ssm
from repro_torch.models.common import apply_norm, init_norm, normal_init


def layer_kind(cfg) -> str:
    if cfg.family == "moe":
        return "attn_moe"
    if cfg.family in ("ssm", "hybrid"):
        return "ssm"
    return "attn_mlp"


def torch_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class _MetaGenerator:
    """Stands in for a `torch.Generator` on the meta device, which torch
    does not make: the init functions draw nothing from it."""
    device = torch.device("meta")


def init_params(seed: int, cfg, dtype: torch.dtype | None = None,
                device="cuda", take=None) -> dict:
    """Random parameters from a `torch.Generator` seeded with ``seed`` on
    ``device`` (float32 draws, then cast to ``dtype``, default the
    config's; the MoE router stays float32).

    ``take(path, subtree)``, when given, is applied to each subtree as
    soon as it is drawn (the embedding, the final norm, each stacked
    block's norms, attention and MLP, the head) and its result is kept:
    the sharded init (`sharding.params.init_sharded_params`) keeps a
    rank's slices, so every rank draws the same numbers and holds at most
    one full subtree at a time. On the meta device the leaves are empty
    meta tensors (`param_shapes`)."""
    dev = resolve_device(device)
    dtype = dtype or torch_dtype(cfg)
    gen = _MetaGenerator() if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    keep = take or (lambda path, tree: tree)
    vp, d, lead = cfg.padded_vocab, cfg.d_model, (cfg.n_layers,)
    params = {
        "embed": keep(("embed",), normal_init(gen, (vp, d), 0.02, dtype)),
        "final_norm": keep(("final_norm",), init_norm(cfg, dtype, dev)),
    }
    if layer_kind(cfg) == "ssm":
        params["layers"] = {
            "ln1": keep(("layers", "ln1"), init_norm(cfg, dtype, dev, lead)),
            "ssm": keep(("layers", "ssm"),
                        ssm.init_ssm(gen, cfg, dtype, lead))}
    else:
        params["layers"] = _init_attn_mlp(
            gen, cfg, dtype, dev, lead, keep, ("layers",),
            use_moe=layer_kind(cfg) == "attn_moe")
    if cfg.family == "hybrid" and cfg.n_shared_blocks:
        params["shared"] = _init_attn_mlp(gen, cfg, dtype, dev,
                                          (cfg.n_shared_blocks,), keep,
                                          ("shared",))
    if not cfg.tie_embeddings:
        params["lm_head"] = keep(("lm_head",),
                                 normal_init(gen, (vp, d), d ** -0.5, dtype))
    return params


def param_shapes(cfg, dtype: torch.dtype | None = None) -> dict:
    """The tree `init_params` makes for ``cfg``, as meta tensors of the
    same shapes and dtypes (no memory, no draws)."""
    return init_params(0, cfg, dtype, device="meta")


def _init_attn_mlp(gen, cfg, dtype, dev, lead, keep, path,
                   use_moe: bool = False) -> dict:
    out = {"ln1": keep(path + ("ln1",), init_norm(cfg, dtype, dev, lead))}
    out["attn"] = keep(path + ("attn",),
                       attention.init_attention(gen, cfg, dtype, lead))
    out["ln2"] = keep(path + ("ln2",), init_norm(cfg, dtype, dev, lead))
    out["ffn"] = keep(path + ("ffn",),
                      moe.init_moe(gen, cfg, dtype, lead) if use_moe
                      else lm_mlp.init_mlp(gen, cfg, dtype, lead))
    return out


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attn_mlp_block(p, cfg, x, positions, *, cache=None, cache_pos=None,
                    cache_layer=None, use_moe=False):
    """Returns (x_out, new_kv, aux_loss); aux_loss is None without MoE."""
    h, new_kv = attention.attention_block(
        p["attn"], cfg, apply_norm(p["ln1"], x, cfg.norm), positions,
        cache=cache, cache_pos=cache_pos, cache_layer=cache_layer)
    x = x + h
    z = apply_norm(p["ln2"], x, cfg.norm)
    if use_moe:
        ff, aux = moe.moe_block(p["ffn"], cfg, z)
    else:
        ff, aux = lm_mlp.mlp_block(p["ffn"], cfg, z), None
    return x + ff, new_kv, aux


def _ssm_layer(p, cfg, x, *, cache=None, cache_layer=None):
    h, new_cache = ssm.ssm_block(p["ssm"], cfg,
                                 apply_norm(p["ln1"], x, cfg.norm),
                                 cache=cache, cache_layer=cache_layer)
    return x + h, new_cache


def hybrid_layout(cfg):
    """(n_super, per_super, tail) decomposition of the zamba2 stack."""
    every = cfg.shared_attn_every
    n_super = cfg.n_layers // every
    return n_super, every, cfg.n_layers - n_super * every


def _tree_slice(tree, i):
    if isinstance(tree, dict):
        return {k: _tree_slice(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def empty_caches(cfg, batch_size: int, slots: int, dtype: torch.dtype,
                 device, tp: int = 1) -> dict:
    """Zeroed caches of ``slots`` positions in the decode layout: "kv" (k, v)
    of (L, B, slots, KV, hd) for `attn_mlp`; "ssm" (conv, state) of the
    `ssm` layers (`ssm.ssm_cache`, states float32); the hybrid's shared
    blocks "shared_kv", one (k, v) slot a super-block. With ``tp`` > 1, a
    model rank's blocks (`sharding.params.cache_blocks`): slots / tp
    positions, the SSM's heads and d_inner channels over tp."""
    if layer_kind(cfg) != "ssm":
        return {"kv": _kv_pair(cfg, cfg.n_layers, batch_size, slots // tp,
                               dtype, device)}
    caches = {"ssm": ssm.ssm_cache(cfg, cfg.n_layers, batch_size, dtype,
                                   device, tp)}
    if cfg.family == "hybrid":
        caches["shared_kv"] = _kv_pair(cfg, hybrid_layout(cfg)[0],
                                       batch_size, slots // tp, dtype,
                                       device)
    return caches


def _kv_pair(cfg, n_stack, batch_size, slots, dtype, device):
    shape = (n_stack, batch_size, slots, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def grouped_caches(cfg, caches: dict) -> dict:
    """The hybrid's flat (n_layers, ...) SSM caches as the JAX package's
    prefill returns them: "ssm_main" (n_super, per_super, ...) and, when
    the stack has a tail, "ssm_tail" (tail, ...), views of the same
    tensors."""
    n_super, per, tail = hybrid_layout(cfg)
    out = {k: v for k, v in caches.items() if k != "ssm"}
    out["ssm_main"] = tuple(t[:n_super * per].reshape(n_super, per,
                                                      *t.shape[1:])
                            for t in caches["ssm"])
    if tail:
        out["ssm_tail"] = tuple(t[n_super * per:] for t in caches["ssm"])
    return out


def _attn_at(p, cfg, x, positions, kv, idx: int, pos0, decoding: bool,
             use_moe: bool = False):
    """An attention + MLP (or MoE) block on cache slot ``idx`` of the
    stacked pair ``kv``: decode writes its token in place, prefill its
    prompt. Returns (x, the block's aux loss or None)."""
    if decoding:
        x, _, aux = _attn_mlp_block(p, cfg, x, positions, cache=kv,
                                    cache_pos=pos0, cache_layer=idx,
                                    use_moe=use_moe)
        return x, aux
    s = x.shape[1]
    x, (k, v), aux = _attn_mlp_block(p, cfg, x, positions, use_moe=use_moe)
    kv[0][idx, :, :s] = k
    kv[1][idx, :, :s] = v
    return x, aux


def _ssm_at(params, cfg, x, stacks, layer: int, decoding: bool):
    """Mamba2 layer ``layer`` on the stacked (conv, state) caches."""
    p = _tree_slice(params["layers"], layer)
    if decoding:
        x, _ = _ssm_layer(p, cfg, x, cache=stacks, cache_layer=layer)
        return x
    x, (conv, state) = _ssm_layer(p, cfg, x)
    stacks[0][layer] = conv
    stacks[1][layer] = state
    return x


def _embed(params, cfg, tokens, prefix_embed):
    # a gather (B, S_text, D); `F.embedding`'s backward sums each row's
    # gradients in a fixed order, where indexing's `index_put_` does not
    x = F.embedding(tokens, params["embed"])
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if prefix_embed is not None:
        x = torch.cat([prefix_embed.to(x.dtype), x], dim=1)
    return x


def _unbind_layers(tree, n: int) -> list:
    """``n`` trees of views, tree l the row l of every stacked leaf."""
    if isinstance(tree, dict):
        per_key = {k: _unbind_layers(v, n) for k, v in tree.items()}
        return [{k: per_key[k][layer] for k in tree} for layer in range(n)]
    return list(torch.unbind(tree))


def forward_train(params, cfg, tokens, *, prefix_embed=None, rules=None):
    """The training forward: (hidden (B, S, D) after the final norm, aux),
    aux the MoE layers' load-balance losses summed in float32 (0.0 for the
    other layer kinds), as the JAX package's `forward` returns them for a
    training step; no caches. Each layer (the hybrid: each super-block and
    each tail layer) is rematerialised in the backward when `cfg.remat`
    and autograd is recording.

    With ``rules`` (`sharding.rules.MeshRules` bound to the mesh of the
    ranks), ``params`` are this rank's blocks and ``tokens`` its batch
    rows: every layer kind on a (data, model) mesh
    (`_forward_train_sharded`); the hidden comes back whole along the
    sequence, as the vocab-parallel loss takes it, and the aux is this
    rank's own."""
    if rules is not None:
        from repro_torch.sharding.spmd import layout

        return _forward_train_sharded(params, layout(cfg, rules),
                                      tokens, prefix_embed)
    x = _embed(params, cfg, tokens, prefix_embed)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    use_moe = layer_kind(cfg) == "attn_moe"

    def attn_block(h, p):
        h, _, aux = _attn_mlp_block(p, cfg, h, positions, use_moe=use_moe)
        return (h, aux) if use_moe else h

    def shared_block(h, p):
        return _attn_mlp_block(p, cfg, h, positions)[0]

    x, aux_total = _through_stack(
        cfg, params, x, attn_block=attn_block,
        ssm_layer=lambda h, p: _ssm_layer(p, cfg, h)[0],
        shared_block=shared_block)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return x, aux_total


def _through_stack(cfg, params, x, *, attn_block, ssm_layer, shared_block):
    """``x`` through the layer stack in its order (the hybrid: each
    super-block's mamba2 layers then its shared block, in turn over
    ``params["shared"]``, then the tail layers), each rematerialised unit
    (a layer, a super-block) under a non-reentrant checkpoint when
    `cfg.remat` and autograd is recording. ``attn_block(h, p)`` returns h,
    or (h, aux) for `attn_moe`; ``ssm_layer(h, p)`` and
    ``shared_block(h, p)`` return h. Returns (x, the aux losses summed in
    float32)."""
    remat = cfg.remat and torch.is_grad_enabled()

    def run(fn, *args):
        if remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def ssm_layers(h, *ps):
        for p in ps:
            h = ssm_layer(h, p)
        return h

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    kind = layer_kind(cfg)
    layers = _unbind_layers(params["layers"], cfg.n_layers)
    if kind == "attn_moe":
        for p in layers:
            x, aux = run(attn_block, x, p)
            aux_total = aux_total + aux
    elif kind == "attn_mlp":
        for p in layers:
            x = run(attn_block, x, p)
    elif cfg.family == "ssm":
        for p in layers:
            x = run(ssm_layers, x, p)
    else:  # hybrid (zamba2)
        n_super, per, _ = hybrid_layout(cfg)
        shared = _unbind_layers(params["shared"], cfg.n_shared_blocks)

        def super_block(h, sp, *ps):
            return shared_block(ssm_layers(h, *ps), sp)

        for sb in range(n_super):
            x = run(super_block, x, shared[sb % cfg.n_shared_blocks],
                    *layers[sb * per:(sb + 1) * per])
        for p in layers[n_super * per:]:
            x = run(ssm_layers, x, p)
    return x, aux_total


def _embed_sharded(params, lay, tokens, prefix_embed,
                   seq_sharded: bool = True):
    """This rank's sequence block (B, S/tp, D) of the embedded input: the
    vocab-parallel lookup (the rank's rows of the table, zeros for a token
    it does not hold), the vlm prefix added on model rank 0 alone, the
    partial sums reduce-scattered over ``model`` along the sequence (a
    decode step's one token: all-reduced, the whole (B, 1, D) on every
    model rank). A token's row comes from its one owner plus zeros, so
    the sum is the row, bit for bit."""
    cfg = lay.cfg
    table = lay.weight(params["embed"], lay.specs["embed"])
    rows = table.shape[0]
    local = tokens - lay.model_rank * rows
    hit = (local >= 0) & (local < rows)
    x = F.embedding(local.clamp(0, rows - 1), table)
    x = torch.where(hit[..., None], x, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if prefix_embed is not None:
        pre = prefix_embed.to(x.dtype)
        x = torch.cat([pre if lay.model_rank == 0 else torch.zeros_like(pre),
                       x], dim=1)
    if not seq_sharded:
        return comm.reduce_from_group(x, lay.model_group)
    lay.check_seq(x.shape[1])
    return comm.reduce_scatter_along(x, lay.model_group, 1)


def _forward_train_sharded(params, lay, tokens, prefix_embed):
    """`forward_train` on a rank of a mesh (`_forward_sharded`), the hidden
    gathered along the sequence."""
    x, aux_total = _forward_sharded(params, lay, tokens, prefix_embed)
    return comm.gather_along(x, lay.model_group, 1), aux_total


def _forward_sharded(params, lay, tokens, prefix_embed, caches=None,
                     pos=None):
    """The layer stack on a rank of a mesh (`sharding.spmd`). Returns (this
    rank's block of the hidden after the final norm, the aux: this rank's
    MoE losses summed over the layers, each over its own tokens;
    `models.lm.lm_loss` averages it over the ranks).

    Training and prefill (``pos`` None): the residual stream
    sequence-sharded over ``model`` between the blocks (the JAX package's
    ``shard_res``), each block on the rank's sequence block after its
    norm: `attention.attention_block_sharded` with
    `lm_mlp.mlp_block_sharded` (`attn_mlp`, the hybrid's shared blocks) or
    `moe.moe_block_sharded` (`attn_moe`), `ssm.ssm_block_sharded` (`ssm`,
    the hybrid's mamba2 layers); the final norm too; the hidden comes back
    as the rank's (B, S/tp, D). With ``caches`` (prefill: the rank's
    blocks, `empty_caches(..., tp=)`) each block also writes its layer's
    cache blocks: the rank's slot block of the prompt's keys and values,
    the SSM's conv inputs and final state of its channels and heads.

    Decode (``pos`` given, ``caches`` the rank's blocks, updated in
    place): the one-token residual (B, 1, D) replicated over ``model``, as
    the JAX package keeps a decode step's, each block in its one-token
    form: `attention.decode_block_sharded` (context-parallel over the
    sequence-sharded cache), the MLP and MoE (``seq_sharded=False``) and
    `ssm.ssm_decode_sharded`, each all-reducing its partial sums over
    ``model``.

    The stack and its rematerialised units are one device's
    (`_through_stack`); each stack's layers take their cache index in
    order."""
    cfg = lay.cfg
    decoding = pos is not None
    x = _embed_sharded(params, lay, tokens, prefix_embed, not decoding)
    specs, shared_specs = lay.layer_specs(), None
    if cfg.family == "hybrid":
        shared_specs = lay.layer_specs("shared")
    use_moe = layer_kind(cfg) == "attn_moe"
    index = {key: itertools.count() for key in ("kv", "shared_kv", "ssm")}

    def norm(p, h, spec):
        return apply_norm({k: lay.weight(p[k], spec[k]) for k in p}, h,
                          cfg.norm)

    def attn_block(h, p, spec=specs, key="kv"):
        z = norm(p["ln1"], h, spec["ln1"])
        if decoding:
            a = attention.decode_block_sharded(
                p["attn"], cfg, z, lay, spec["attn"], caches[key],
                next(index[key]), pos)
        elif caches is not None:
            a, kv = attention.attention_block_sharded(
                p["attn"], cfg, z, lay, spec["attn"], kv_out=True)
            _write_slots(caches[key], next(index[key]), kv, lay.model_rank)
        else:
            a = attention.attention_block_sharded(p["attn"], cfg, z, lay,
                                                  spec["attn"])
        h = h + a
        z = norm(p["ln2"], h, spec["ln2"])
        if use_moe:
            ff, aux = moe.moe_block_sharded(p["ffn"], cfg, z, lay,
                                            spec["ffn"],
                                            seq_sharded=not decoding)
            return h + ff, aux
        return h + lm_mlp.mlp_block_sharded(p["ffn"], cfg, z, lay,
                                            spec["ffn"],
                                            seq_sharded=not decoding)

    def ssm_layer(h, p):
        z = norm(p["ln1"], h, specs["ln1"])
        if decoding:
            return h + ssm.ssm_decode_sharded(p["ssm"], cfg, z, lay,
                                              specs["ssm"], caches["ssm"],
                                              next(index["ssm"]))
        if caches is None:
            return h + ssm.ssm_block_sharded(p["ssm"], cfg, z, lay,
                                             specs["ssm"])
        out, blocks = ssm.ssm_block_sharded(p["ssm"], cfg, z, lay,
                                            specs["ssm"], cache_out=True)
        i = next(index["ssm"])
        for stack, t in zip(caches["ssm"], blocks):
            stack[i] = t
        return h + out

    x, aux_total = _through_stack(
        cfg, params, x, attn_block=attn_block, ssm_layer=ssm_layer,
        shared_block=lambda h, p: attn_block(h, p, shared_specs,
                                             "shared_kv"))
    return norm(params["final_norm"], x, lay.specs["final_norm"]), aux_total


def _write_slots(cache, idx: int, kv, m: int) -> None:
    """The prompt's (k, v), each (B, S, KV, hd), into model rank ``m``'s
    slot block of layer ``idx`` of its (k, v) stacks (L, B, S_max/tp, KV,
    hd): the positions m·S_max/tp onward that the prompt holds."""
    sb = cache[0].shape[2]
    n = max(0, min(sb, kv[0].shape[1] - m * sb))
    for stack, t in zip(cache, kv):
        stack[idx, :, :n] = t[:, m * sb:m * sb + n]


@torch.no_grad()
def _serve_sharded(params, lay, tokens, prefix_embed, caches, pos0, s_max):
    """`forward`'s prefill (``caches`` None: the rank's fresh blocks of
    s_max slots, default the prompt's length) and decode on a rank of a
    mesh, no autograd."""
    if caches is None:
        s = tokens.shape[1] + (prefix_embed.shape[1]
                               if prefix_embed is not None else 0)
        s_max = s if s_max is None else s_max
        if s_max < s:
            raise ValueError(f"forward: the prompt holds {s} positions, more "
                             f"than s_max={s_max}")
        from repro_torch.sharding.params import check_serve

        check_serve(lay.rules, lay.mesh, s_max=s_max)
        caches = empty_caches(lay.cfg, tokens.shape[0], s_max,
                              params["embed"].dtype, tokens.device, lay.tp)
        x, aux = _forward_sharded(params, lay, tokens, prefix_embed, caches)
        return x, caches, aux
    kv = caches.get("kv", caches.get("shared_kv"))
    if kv is not None and pos0 >= kv[0].shape[2] * lay.tp:
        # no rank owns the slot: the token would be dropped, not refused
        raise ValueError(f"forward: decode at position {pos0}, past the "
                         f"caches' s_max={kv[0].shape[2] * lay.tp} slots")
    x, aux = _forward_sharded(params, lay, tokens, None, caches, pos0)
    return x, caches, aux


def forward(params, cfg, tokens, *, prefix_embed=None, caches=None,
            pos0=None, s_max=None, rules=None):
    """Shared forward for prefill (caches=None: fresh caches are returned)
    and decode (caches given: one-token step at position pos0, caches
    updated in place).

    With ``rules`` (`sharding.rules.MeshRules` bound to the mesh of the
    ranks; no autograd): ``params`` are this rank's blocks, ``tokens`` and
    ``prefix_embed`` its batch rows, and the caches its blocks in the
    decode layout (`sharding.params.cache_blocks`; prefill makes them
    with s_max slots, default the prompt's length). The hidden is this
    rank's sequence block (B, S/tp, D) in prefill and the whole (B, 1, D)
    in decode (`_forward_sharded`).

    Prefill with s_max returns the decode layout (`empty_caches`: s_max
    slots, the prompt in the first S); without it, the JAX package's
    prefill layout: S slots, and the hybrid's SSM caches grouped by
    super-block (`grouped_caches`). tokens (B, S_text) integer;
    prefix_embed (B, P, D) for vlm. Returns (hidden (B, S, D),
    new_caches, aux_loss): the MoE layers' load-balance losses summed in
    float32 over a prefill, a 0-dim tensor; 0.0 in decode and for the
    other layer kinds, as the JAX package returns it.
    """
    if rules is not None:
        from repro_torch.sharding.spmd import layout

        return _serve_sharded(params, layout(cfg, rules), tokens,
                              prefix_embed, caches, pos0, s_max)
    x = _embed(params, cfg, tokens, prefix_embed)
    b, s, _ = x.shape

    decoding = caches is not None
    if decoding:
        positions = torch.full((b, 1), pos0, device=x.device)
    else:
        slots = s if s_max is None else s_max
        if slots < s:
            raise ValueError(f"forward: the prompt holds {s} positions, more "
                             f"than s_max={s_max}")
        positions = torch.arange(s, device=x.device).expand(b, s)
        caches = empty_caches(cfg, b, slots, x.dtype, x.device)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if layer_kind(cfg) != "ssm":
        use_moe = layer_kind(cfg) == "attn_moe"
        for layer in range(cfg.n_layers):
            x, aux = _attn_at(_tree_slice(params["layers"], layer), cfg, x,
                              positions, caches["kv"], layer, pos0, decoding,
                              use_moe=use_moe)
            if use_moe and not decoding:
                aux_total = aux_total + aux
    elif cfg.family == "ssm":
        for layer in range(cfg.n_layers):
            x = _ssm_at(params, cfg, x, caches["ssm"], layer, decoding)
    else:  # hybrid (zamba2)
        n_super, per, _ = hybrid_layout(cfg)
        for sb in range(n_super):
            for layer in range(sb * per, (sb + 1) * per):
                x = _ssm_at(params, cfg, x, caches["ssm"], layer, decoding)
            shared = _tree_slice(params["shared"], sb % cfg.n_shared_blocks)
            x, _ = _attn_at(shared, cfg, x, positions, caches["shared_kv"],
                            sb, pos0, decoding)
        for layer in range(n_super * per, cfg.n_layers):
            x = _ssm_at(params, cfg, x, caches["ssm"], layer, decoding)

    x = apply_norm(params["final_norm"], x, cfg.norm)
    if not decoding and s_max is None and cfg.family == "hybrid":
        caches = grouped_caches(cfg, caches)
    return x, caches, aux_total


def logits_from_hidden(params, cfg, hidden):
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return hidden @ table.T
