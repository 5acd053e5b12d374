"""Stuck-at fault lanes of a levelized circuit: Hopper kernel and plain
version.

Replaces no TPU kernel: the JAX package's simulator
(`repro/core/faults.py::FaultSimulator`) runs its level chain as jnp
gathers and `where`s. `fault_lanes` runs every lane of a
`core.faults.FaultSimulator.run_masks` call on the card in one launch
(`csrc/fault_sim.cu`: a block a lane and tile of words, the tile's value
table in shared memory, or in global scratch for a circuit too large for
it, one barrier a logic level; its bound and design are stated there). On
a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.

The operands (`FaultTables`, made once per circuit by `fault_tables`) hold
the circuit in table order: the base gates (inputs and constants) first,
then each logic level's gates, every gate's operands as rows of lower
levels. Samples are packed 32 to an int32 word, sample 32w + j at bit j of
word w (`pack_words`). The plain version is the level chain of the CPU
simulator (`run_chunk_plain`: the same gathers, `torch.where`s and stuck
overrides over a packed (G, lanes, words) table) on those words.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.netlist import AND, NOT, OR, XOR
from repro_torch.kernels import _build
from repro_torch.runtime import trace

# a link codes a logic gate's op as its truth table: bit 2a + b is op(a, b)
TRUTH = {NOT: 0b0011, AND: 0b1000, OR: 0b1110, XOR: 0b0110}
TRUTH_SHIFT = 28         # a link's b row in the low 28 bits, its table above
ROW_MASK = (1 << TRUTH_SHIFT) - 1
TILE_LOGS = (2, 3)       # tiles of 4 or 8 words (128 or 256 samples)
BASE_ALIGN = 8           # words a base row is padded to (`pack_words`)
SMEM_LIMIT = 232448      # a block's dynamic shared memory on the H100
BLOCKS_PER_SM = 4        # the grid's blocks a multiprocessor


class FaultTables(NamedTuple):
    """One circuit's operands of `fault_lanes`, on its device."""

    links: torch.Tensor      # (G - n_base, 2) int32: a, b row | truth << 28
    level_off: torch.Tensor  # (n_levels + 1,) int32: each level's first row
    gate_row: torch.Tensor   # (G,) int32: the row of each gate id
    out_rows: torch.Tensor   # (n_out,) int32: rows of the class bits
    n_base: int

    @property
    def n_gates(self) -> int:
        return self.gate_row.shape[0]


def fault_tables(op, a, b, out_bits, base, levels, to) -> FaultTables:
    """`FaultTables` of a circuit's gate arrays ``op``, ``a``, ``b`` and
    ``out_bits`` under its level schedule (``base``, ``levels``:
    `netlist.level_gates`); ``to(array)`` puts each int32 array on the
    device."""
    order = np.concatenate([base, *levels]).astype(np.int64)
    row = np.empty(order.size, np.int64)
    row[order] = np.arange(order.size)
    logic = order[len(base):]
    truth = np.zeros(8, np.int64)
    truth[list(TRUTH)] = list(TRUTH.values())
    links = np.stack([row[a[logic]], row[np.maximum(b[logic], 0)]
                      | truth[op[logic]] << TRUTH_SHIFT], 1)
    sizes = [len(base)] + [len(lv) for lv in levels]
    return FaultTables(
        to(links.reshape(-1, 2).astype(np.uint32).view(np.int32)),
        to(np.cumsum(sizes)), to(row), to(row[list(out_bits)]), len(base))


def pack_words(bits: torch.Tensor) -> torch.Tensor:
    """(..., B) bool -> (..., W) int32 words, sample 32w + j at bit j of
    word w (bit 31 the sign); W is ceil(B / 32) rounded up to a multiple of
    `BASE_ALIGN`, the words past the samples 0."""
    n = bits.shape[-1]
    words = -(-n // (32 * BASE_ALIGN)) * BASE_ALIGN
    padded = torch.nn.functional.pad(bits.to(torch.int32), (0, 32 * words - n))
    weight = torch.tensor([1 << j for j in range(31)] + [-(1 << 31)],
                          dtype=torch.int32, device=bits.device)
    return (padded.view(*bits.shape[:-1], words, 32) * weight).sum(
        -1, dtype=torch.int32)


def run_chunk_plain(vals, base_rows, mask, val, cls, levels, out_rows,
                    out_shift, bit_shift) -> None:
    """The level chain over a packed value table: ``vals`` (G, lanes, W)
    words in table order, ``base_rows`` (n_base, 1 or lanes, W) their
    fault-free words, ``mask`` (G, lanes, 1) bool and ``val`` (G, lanes, 1)
    words of 0s or 1s the stuck overrides in table order, ``levels`` (lo,
    hi, a rows, b rows, is NOT, AND, OR) of each logic level; ``cls``
    (lanes, B) int32 receives the classes of the rows ``out_rows``, bit i
    shifted by ``out_shift`` (n_out, 1, 1), a word's bits by ``bit_shift``
    (its width)."""
    n0 = base_rows.shape[0]
    torch.where(mask[:n0], val[:n0], base_rows, out=vals[:n0])
    for lo, hi, a_rows, b_rows, is_not, is_and, is_or in levels:
        av = vals.index_select(0, a_rows)
        bv = vals.index_select(0, b_rows)
        out = torch.where(
            is_not, ~av,
            torch.where(is_and, av & bv,
                        torch.where(is_or, av | bv, av ^ bv)))
        torch.where(mask[lo:hi], val[lo:hi], out, out=vals[lo:hi])
    words = vals.index_select(0, out_rows)   # (bits, lanes, W)
    bits = ((words[..., None] >> bit_shift) & 1).flatten(-2)
    cls.copy_((bits[..., :cls.shape[-1]].to(torch.int32)
               << out_shift).sum(0, dtype=torch.int32))


def fault_lanes_plain(base: torch.Tensor, tables: FaultTables,
                      mask: torch.Tensor, value: torch.Tensor,
                      batch: int) -> torch.Tensor:
    """Plain PyTorch version of `fault_lanes`: `run_chunk_plain` over an
    int32 (G, S, W) table."""
    dev = base.device
    n_words = base.shape[1]
    gate_row = tables.gate_row.long()
    rows = torch.empty_like(gate_row).scatter_(
        0, gate_row, torch.arange(tables.n_gates, device=dev))
    mask_t = mask.index_select(1, rows).T[..., None]
    val_t = torch.where(value.index_select(1, rows).T[..., None], -1, 0).to(
        torch.int32)
    links = tables.links.long()
    off = tables.level_off.tolist()
    levels = []
    for lo, hi in zip(off, off[1:]):
        a_rows = links[lo - tables.n_base:hi - tables.n_base, 0]
        b_link = links[lo - tables.n_base:hi - tables.n_base, 1] % (1 << 32)
        truth = (b_link >> TRUTH_SHIFT)[:, None, None]
        levels.append((lo, hi, a_rows, b_link & ROW_MASK,
                       truth == TRUTH[NOT], truth == TRUTH[AND],
                       truth == TRUTH[OR]))
    vals = torch.empty((tables.n_gates, mask.shape[0], n_words),
                       dtype=torch.int32, device=dev)
    cls = torch.empty((mask.shape[0], batch), dtype=torch.int32, device=dev)
    shift = torch.arange(32, dtype=torch.int32, device=dev)
    run_chunk_plain(vals, base[:, None, :], mask_t, val_t, cls, levels,
                    tables.out_rows.long(),
                    shift[:tables.out_rows.shape[0], None, None], shift)
    return cls


def placement(n_gates: int) -> tuple[int, bool]:
    """(log2 of the tile's words, whether the lane state lives in shared
    memory) for a circuit of ``n_gates`` gates: 4-word tiles in shared
    memory where their lane state fits a block's; past that, 8-word tiles
    in global scratch."""
    if 4 * state_words(n_gates, TILE_LOGS[0]) <= SMEM_LIMIT:   # bytes
        return TILE_LOGS[0], True
    return TILE_LOGS[1], False


def state_words(n_gates: int, log_t: int) -> int:
    """A block's lane state in words: the (G, T) value table and the stuck
    bits, each rounded up to a multiple of 4 (`csrc/fault_sim.cu`'s
    `state_words`)."""
    return (-(-(n_gates << log_t) // 4) * 4
            + -(-2 * (-(-n_gates // 32)) // 4) * 4)


def fault_lanes(base: torch.Tensor, tables: FaultTables, mask: torch.Tensor,
                value: torch.Tensor, batch: int,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """(S, B) int32 classes of ``S`` fault lanes: ``base`` (n_base, W)
    int32 fault-free words of the base rows (`pack_words`: W the words of B
    samples rounded up to `BASE_ALIGN`), ``mask`` and ``value`` (S, G) bool
    stuck masks and values by gate id; into ``out`` where given. Counts its
    kernel launches in ``launches.fault_lanes``."""
    dev = base.device
    g, n_base = tables.n_gates, tables.n_base
    n_lanes, n_words = mask.shape[0], -(-batch // 32)
    stride = -(-n_words // BASE_ALIGN) * BASE_ALIGN
    _build.require(base, "base", torch.int32, dev, (n_base, stride))
    _build.require(tables.links, "links", torch.int32, dev, (g - n_base, 2))
    for name in ("level_off", "gate_row", "out_rows"):
        _build.require(getattr(tables, name), name, torch.int32, dev)
    for name, t in (("mask", mask), ("value", value)):
        _build.require(t, name, torch.bool, dev, (n_lanes, g))
    if out is None:
        out = torch.empty((n_lanes, batch), dtype=torch.int32, device=dev)
    _build.require(out, "out", torch.int32, dev, (n_lanes, batch))
    if not _build.on_cuda(base, "fault_lanes"):
        out.copy_(fault_lanes_plain(base, tables, mask, value, batch))
        return out
    if n_lanes == 0 or batch == 0:
        return out
    for name, t, align in (("links", tables.links, 8), ("base", base, 16)):
        if t.data_ptr() % align:
            raise ValueError(f"{name} must start on a {align}-byte boundary")
    log_t, in_smem = placement(g)
    grid = min(n_lanes * -(-n_words >> log_t), BLOCKS_PER_SM
               * torch.cuda.get_device_properties(dev).multi_processor_count)
    scratch = None
    if not in_smem:
        scratch = torch.empty((grid * state_words(g, log_t),),
                              dtype=torch.int32, device=dev)
    fn = _build.function("fault_sim", "repro_fault_lanes", 9, 10)
    rc = fn(_build.ptr(base), _build.ptr(tables.links),
            _build.ptr(tables.level_off), _build.ptr(tables.gate_row),
            _build.ptr(tables.out_rows), _build.ptr(mask), _build.ptr(value),
            _build.ptr(out),
            ctypes.c_void_p(None if scratch is None else scratch.data_ptr()),
            n_lanes, batch, g, n_base, tables.level_off.shape[0] - 1,
            tables.out_rows.shape[0], n_words, stride, log_t, grid,
            _build.stream(dev))
    _build.check_launch(rc, "fault_lanes")
    trace.count("launches.fault_lanes")
    return out
