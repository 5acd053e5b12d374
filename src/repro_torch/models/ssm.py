"""Mamba2 (SSD, state-space duality) layer: chunked prefill and the O(1)
decode recurrence.

Counterpart of `repro.models.ssm`: `ssm_block` on one device,
`ssm_block_sharded` on a rank of a mesh (`sharding.spmd`). The
projections are separate weight blocks (z / x / BC / dt) as in the JAX
package, with a single B/C group (n_groups=1, as mamba2-1.3b and zamba2).
`ssd_chunked` walks the chunks in a Python loop carrying the (B, NH, HD, N)
state, where the JAX package scans them; within a chunk it keeps the JAX
package's arithmetic: the cumulative decay in float32 along the chunk's
axis, and the (B, Q, Q, NH) weight block and the chunk's inputs rounded to
bfloat16 whatever the model's dtype, then contracted in float32 (a
product of two bf16 values is exact in float32, so only the summation order
differs from XLA's). The SSD scan, the depthwise conv and the decode
recurrence have no Pallas kernel in the JAX package; here they are plain
PyTorch (einsums, cuBLAS where JAX uses XLA dots).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import comm
from repro_torch.models.common import norm_like, normal_init


def conv_channels(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


def ssm_cache(cfg, n_stack: int, batch_size: int, dtype: torch.dtype,
              device, tp: int = 1):
    """Zeroed (conv (n_stack, B, K-1, C) in ``dtype``, state (n_stack, B, NH,
    HD, N) float32) decode caches of ``n_stack`` layers; the states are
    float32 in every model dtype. With ``tp`` > 1, a model rank's blocks:
    C = d_inner/tp + 2N (its x channels, then the whole B and C), NH/tp
    heads."""
    conv = torch.zeros((n_stack, batch_size, cfg.ssm_conv - 1,
                        cfg.d_inner // tp + 2 * cfg.ssm_state), dtype=dtype,
                       device=device)
    state = torch.zeros((n_stack, batch_size, cfg.ssm_nheads // tp,
                         cfg.ssm_head_dim, cfg.ssm_state),
                        dtype=torch.float32, device=device)
    return conv, state


def init_ssm(gen: torch.Generator, cfg, dtype: torch.dtype, lead=()) -> dict:
    """Mamba2 weights, with leading axes ``lead`` (the layer stack). As in
    the JAX package, ``a_log``, ``d_skip`` and ``dt_bias`` are float32 in
    every model dtype (A = -exp(a_log) = -1, D = 1, no dt bias)."""
    d, nh, n, di = cfg.d_model, cfg.ssm_nheads, cfg.ssm_state, cfg.d_inner
    dev = gen.device

    def full(shape, value, dt):
        return torch.full((*lead, *shape), value, dtype=dt, device=dev)

    std = d ** -0.5
    return {
        "z_proj": normal_init(gen, (*lead, d, di), std, dtype),
        "x_proj": normal_init(gen, (*lead, d, di), std, dtype),
        "bc_proj": normal_init(gen, (*lead, d, 2 * n), std, dtype),
        "dt_proj": normal_init(gen, (*lead, d, nh), std, dtype),
        "conv_x_w": normal_init(gen, (*lead, cfg.ssm_conv, di), 0.2, dtype),
        "conv_x_b": full((di,), 0.0, dtype),
        "conv_bc_w": normal_init(gen, (*lead, cfg.ssm_conv, 2 * n), 0.2,
                                 dtype),
        "conv_bc_b": full((2 * n,), 0.0, dtype),
        "a_log": full((nh,), 0.0, torch.float32),
        "d_skip": full((nh,), 1.0, torch.float32),
        "dt_bias": full((nh,), 0.0, torch.float32),
        "norm_w": full((di,), 1.0, dtype),
        "out_proj": normal_init(gen, (*lead, di, d), di ** -0.5, dtype),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """x (B, S, C); w (K, C); left-padded by K-1: a causal depthwise conv,
    its taps added in the JAX package's order."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s, :] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s, :] * w[i]
    return out + b


def _bf16_exact(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 and held in float32 (the JAX package's
    bf16 operands of a float32-accumulated einsum)."""
    return t.to(torch.bfloat16).to(torch.float32)


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_: torch.Tensor, c_: torch.Tensor, d_skip: torch.Tensor,
                chunk: int):
    """SSD forward. xh (B, S, NH, HD) float32; dt (B, S, NH) float32
    (post-softplus); a (NH,) negative; b_, c_ (B, S, N) float32. Returns y
    (B, S, NH, HD) float32 and the final state (B, NH, HD, N).

    The chunk is ``min(chunk, S)``; a longer S must be a multiple of it
    (the JAX package's reshape refuses it too; nothing is padded).
    """
    bsz, s, nh, hd = xh.shape
    n = b_.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"ssd_chunked: the sequence of {s} positions is "
                         f"not a multiple of the SSD chunk {q}")
    tril = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
    state = xh.new_zeros((bsz, nh, hd, n), dtype=torch.float32)
    ys = []
    for c0 in range(0, s, q):
        xq, dtq = xh[:, c0:c0 + q], dt[:, c0:c0 + q]
        bq, cq = b_[:, c0:c0 + q], c_[:, c0:c0 + q]
        cum = torch.cumsum(dtq * a, dim=1)                  # (B, q, nh)
        # intra-chunk: y_i += sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j
        diff = cum[:, :, None, :] - cum[:, None, :, :]     # (B, i, j, nh)
        # masked before the exp: above the diagonal diff > 0 can overflow
        # to inf, whose masked gradient 0 * inf is NaN (the forward is
        # the JAX package's where(tril, exp(diff), 0), bit for bit)
        decay = torch.exp(torch.where(tril[None, :, :, None], diff,
                                      float("-inf")))
        scores = torch.einsum("bin,bjn->bij", cq, bq)
        w = _bf16_exact(scores[..., None] * decay * dtq[:, None, :, :])
        y = torch.einsum("bijh,bjhp->bihp", w, _bf16_exact(xq))
        # prior-state contribution: C_i . state decayed from the chunk start
        y = y + torch.einsum("bin,bhpn,bih->bihp", cq, state, torch.exp(cum))
        # state update: decay the whole chunk, inject inputs decayed to its
        # end
        end_decay = torch.exp(cum[:, -1:, :] - cum)         # (B, j, nh)
        state = (state * torch.exp(cum[:, -1, :])[:, :, None, None]
                 + torch.einsum("bjn,bjh,bjhp->bhpn", bq, dtq * end_decay,
                                xq))
        ys.append(y)
    y = torch.cat(ys, dim=1) + d_skip[None, None, :, None] * xh
    return y, state


def _conv_step(conv_state: torch.Tensor, xin: torch.Tensor,
               bc: torch.Tensor, p: dict):
    """The depthwise conv at one new position: ``conv_state`` (B, K-1, C)
    the last inputs packed [x | B | C], ``xin`` (B, 1, Cx) and ``bc`` (B,
    1, 2N) the new ones. Returns (conv_x, conv_bc) (B, 1, .) and the
    window shifted by one."""
    cx = xin.shape[-1]
    window_x = torch.cat([conv_state[..., :cx], xin], dim=1)
    window_bc = torch.cat([conv_state[..., cx:], bc], dim=1)
    conv_x = (torch.einsum("bkc,kc->bc", window_x, p["conv_x_w"])
              + p["conv_x_b"])[:, None, :]
    conv_bc = (torch.einsum("bkc,kc->bc", window_bc, p["conv_bc_w"])
               + p["conv_bc_b"])[:, None, :]
    return conv_x, conv_bc, torch.cat([window_x[:, 1:, :],
                                       window_bc[:, 1:, :]], dim=-1)


def _state_step(state: torch.Tensor, xh, dt, a, b_, c_, d_skip):
    """The O(1) recurrence at one new position: ``state`` (B, NH, HD, N)
    float32; xh (B, 1, NH, HD), dt (B, 1, NH), b_, c_ (B, 1, N). Returns
    y (B, 1, NH, HD) and the new state."""
    da = dt[:, 0, :] * a                                    # (B, nh)
    inject = torch.einsum("bn,bh,bhp->bhpn", b_[:, 0], dt[:, 0], xh[:, 0])
    state = state * torch.exp(da)[:, :, None, None] + inject
    y = torch.einsum("bn,bhpn->bhp", c_[:, 0], state)
    return (y + d_skip[None, :, None] * xh[:, 0])[:, None], state


def ssm_block(params: dict, cfg, x: torch.Tensor, cache=None,
              cache_layer=None, chunk: int = 256):
    """The full Mamba2 block. cache None: prefill, returning the block's
    fresh (conv (B, K-1, C), state (B, NH, HD, N)). Decode: cache = (conv
    stack (L, B, K-1, C), state stack (L, B, NH, HD, N)), both updated in
    place at ``cache_layer`` and returned. The conv cache packs the [x | B |
    C] channels."""
    bsz, s, _ = x.shape
    di, n, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, \
        cfg.ssm_head_dim
    z = x @ params["z_proj"]
    xin = x @ params["x_proj"]
    bc = x @ params["bc_proj"]
    dt = x @ params["dt_proj"]

    layer = cache_layer if cache_layer is not None else 0
    k = cfg.ssm_conv
    if cache is None:
        conv_x = _causal_depthwise_conv(xin, params["conv_x_w"],
                                        params["conv_x_b"])
        conv_bc = _causal_depthwise_conv(bc, params["conv_bc_w"],
                                         params["conv_bc_b"])
        packed = torch.cat([xin, bc], dim=-1)
        new_conv = (packed[:, -(k - 1):, :] if s >= k - 1
                    else F.pad(packed, (0, 0, k - 1 - s, 0)))
    else:
        conv_stack, state_stack = cache
        conv_x, conv_bc, new_conv = _conv_step(conv_stack[layer], xin, bc,
                                               params)

    conv_x = F.silu(conv_x.to(torch.float32))
    conv_bc = F.silu(conv_bc.to(torch.float32))
    b_, c_ = conv_bc[..., :n], conv_bc[..., n:]
    xh = conv_x.reshape(bsz, s, nh, hd)
    dt = dt.to(torch.float32) + params["dt_bias"]
    dt = torch.logaddexp(dt, torch.zeros_like(dt))        # softplus
    a = -torch.exp(params["a_log"])

    if cache is None:
        y, final_state = ssd_chunked(xh, dt, a, b_, c_, params["d_skip"],
                                     chunk)
        new_cache = (new_conv, final_state)
    else:
        y, ssm_state = _state_step(state_stack[layer], xh, dt, a, b_, c_,
                                   params["d_skip"])
        conv_stack[layer] = new_conv
        state_stack[layer] = ssm_state
        new_cache = (conv_stack, state_stack)

    y = y.reshape(bsz, s, di).to(x.dtype)
    z = F.silu(z.to(torch.float32)).to(x.dtype)
    y = norm_like(params, params["norm_w"], y * z, cfg.norm)
    return y @ params["out_proj"], new_cache


def ssm_block_sharded(params: dict, cfg, z: torch.Tensor, lay,
                      specs: dict, chunk: int = 256, cache_out: bool = False):
    """The training and prefill Mamba2 block on a rank of a mesh: ``z``
    (B, S/tp, D) this rank's sequence block of the normed residual;
    returns its block of the block's output, (B, S/tp, D), and with
    ``cache_out`` also the rank's decode caches: (conv (B, K-1, di/tp + 2N),
    the last K-1 inputs of its d_inner channels and the whole B/C
    channels; the SSD's final state of its heads (B, NH/tp, HD, N)).
    ``specs`` lays out ``params`` (one layer's).

    The input is gathered along the sequence. ``z_proj``, ``x_proj`` and
    ``dt_proj`` are column-parallel on the rank's d_inner channels and
    heads, ``conv_x_w`` holds its channels, and the replicated
    ``conv_x_b``, ``norm_w``, ``a_log``, ``d_skip`` and ``dt_bias`` are
    cut to them (their gradients summed over ``model`` by `Layout.weight`);
    ``bc_proj`` and the B/C conv are used whole. The SSD scan runs
    unchanged on the rank's heads. The gated norm averages over the whole
    d_inner: its sum of squares is summed over ``model`` forward and its
    gradient summed over ``model`` backward (`comm.reduce_from_group`, then
    `comm.copy_to_group`). ``out_proj`` is row-parallel and its partial
    sums are reduce-scattered back onto the sequence."""
    x = comm.gather_along(z, lay.model_group, 1)
    bsz, s, _ = x.shape
    p = _local_params(params, lay, specs)
    nh_l, hd, k = p["dt_proj"].shape[-1], cfg.ssm_head_dim, cfg.ssm_conv
    zg = x @ p["z_proj"]
    xin = x @ p["x_proj"]
    bc = x @ p["bc_proj"]
    dt = x @ p["dt_proj"]
    conv_x = F.silu(_causal_depthwise_conv(xin, p["conv_x_w"],
                                           p["conv_x_b"]).to(torch.float32))
    conv_bc = F.silu(_causal_depthwise_conv(bc, p["conv_bc_w"],
                                            p["conv_bc_b"]).to(torch.float32))
    n = cfg.ssm_state
    b_, c_ = conv_bc[..., :n], conv_bc[..., n:]
    xh = conv_x.reshape(bsz, s, nh_l, hd)
    dt = dt.to(torch.float32) + p["dt_bias"]
    dt = torch.logaddexp(dt, torch.zeros_like(dt))        # softplus
    y, state = ssd_chunked(xh, dt, -torch.exp(p["a_log"]), b_, c_,
                           p["d_skip"], chunk)
    out = _gated_out(y, zg, p, cfg, lay, x.dtype)
    out = comm.reduce_scatter_along(out, lay.model_group, 1)
    if not cache_out:
        return out
    packed = torch.cat([xin, bc], dim=-1)
    conv = (packed[:, -(k - 1):, :] if s >= k - 1
            else F.pad(packed, (0, 0, k - 1 - s, 0)))
    return out, (conv, state)


def ssm_decode_sharded(params: dict, cfg, x: torch.Tensor, lay,
                       specs: dict, cache, layer: int) -> torch.Tensor:
    """The one-token Mamba2 block on a rank of a mesh: ``x`` (B, 1, D) the
    normed residual, the same on every model rank; ``cache`` the rank's
    (conv (L, B, K-1, di/tp + 2N), state (L, B, NH/tp, HD, N)) stacks,
    updated in place at ``layer``. The decode recurrence of `ssm_block`
    on the rank's channels and heads; the gated norm's sum of squares and
    ``out_proj``'s partial sums all-reduced over ``model``. Returns (B, 1,
    D), the same on every model rank."""
    bsz = x.shape[0]
    p = _local_params(params, lay, specs)
    nh_l, n = p["dt_proj"].shape[-1], cfg.ssm_state
    conv_stack, state_stack = cache
    zg = x @ p["z_proj"]
    conv_x, conv_bc, new_conv = _conv_step(conv_stack[layer],
                                           x @ p["x_proj"], x @ p["bc_proj"],
                                           p)
    conv_x = F.silu(conv_x.to(torch.float32))
    conv_bc = F.silu(conv_bc.to(torch.float32))
    xh = conv_x.reshape(bsz, 1, nh_l, cfg.ssm_head_dim)
    dt = (x @ p["dt_proj"]).to(torch.float32) + p["dt_bias"]
    dt = torch.logaddexp(dt, torch.zeros_like(dt))        # softplus
    y, state = _state_step(state_stack[layer], xh, dt,
                           -torch.exp(p["a_log"]), conv_bc[..., :n],
                           conv_bc[..., n:], p["d_skip"])
    conv_stack[layer] = new_conv
    state_stack[layer] = state
    return comm.reduce_from_group(_gated_out(y, zg, p, cfg, lay, x.dtype),
                                  lay.model_group)


def _local_params(params: dict, lay, specs: dict) -> dict:
    """The weights a rank multiplies by: its blocks through `Layout.weight`,
    the replicated per-channel and per-head leaves cut to its d_inner
    channels and heads."""
    p = {k: lay.weight(params[k], specs[k]) for k in params}
    di_l, nh_l = p["x_proj"].shape[-1], p["dt_proj"].shape[-1]
    m = lay.model_rank
    for k in ("conv_x_b", "norm_w"):
        if p[k].shape[-1] != di_l:
            p[k] = p[k].narrow(-1, m * di_l, di_l)
    for k in ("a_log", "d_skip", "dt_bias"):
        if p[k].shape[-1] != nh_l:
            p[k] = p[k].narrow(-1, m * nh_l, nh_l)
    return p


def _gated_out(y: torch.Tensor, zg: torch.Tensor, p: dict, cfg, lay,
               dtype: torch.dtype) -> torch.Tensor:
    """The gated RMS norm over the whole d_inner (its sum of squares summed
    over ``model``), then ``out_proj``'s partial sums on the rank's
    channels: y (B, S, NH/tp, HD) float32, zg (B, S, di/tp)."""
    bsz, s = y.shape[:2]
    y = y.reshape(bsz, s, -1).to(dtype)
    v = (y * F.silu(zg.to(torch.float32)).to(dtype)).to(torch.float32)
    ss = (v * v).sum(-1, keepdim=True)
    ss = comm.copy_to_group(comm.reduce_from_group(ss, lay.model_group),
                            lay.model_group)
    v = v * torch.rsqrt(ss / cfg.d_inner + 1e-6) * p["norm_w"].to(
        torch.float32)
    return v.to(dtype) @ p["out_proj"]
