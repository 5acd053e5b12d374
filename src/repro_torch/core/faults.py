"""Gate-level stuck-at fault injection on the netlist IR, on torch.

The counterpart of `repro.core.faults` (DESIGN.md §17). Printed circuits
are fabricated at yields where single gates fail, so a Pareto design's
area/accuracy pair is incomplete without the accuracy that survives a
stuck gate. This module turns any `core.netlist.Circuit` into a
fault-injection target:

  - `enumerate_fault_sites(circuit)` lists every injectable site: the
    output of each logic gate and each primary-input bit (INPUT gates).
    Constants are not sites: a CONST gate is a stuck wire already.
  - `FaultSimulator` evaluates fault lanes x test vectors as one batched
    program on its device. Its evaluator repeats `netlist.simulate` gate
    for gate (the same `level_gates` schedule, the same per-level gathers
    and `torch.where` chain) and applies each lane's stuck-at overrides
    after the base level and after every logic level, so a lane with an
    empty mask equals `netlist.simulate` exactly.
  - `simulate_faulty_serial` is the naive oracle: a numpy loop over gates
    in topological order with the faults applied on the way, sharing no
    torch code with the simulator.

Lanes are dense (G,) stuck masks and values, so one simulator serves both
campaign shapes: single stuck-at faults are one-hot masks (`site_masks`),
Monte-Carlo defects multi-hot masks (`search.robustness`). Chunking is
invisible in the result.

Layout. The gates stand in level order (the base gates, then each logic
level's) and the samples are packed into words, so every boolean op acts
on a word of samples at once and a stuck value is a word of 0s or 1s. On
the card a `run_masks` call is one launch of `kernels.fault_sim.fault_lanes`
over every lane (an explicit ``chunk`` splits it into launches of that
many lanes): it reads the lanes' (S, G) masks and values as they are
uploaded and writes the (S, B) classes that are read back; its tables
(`fault_sim.FaultTables`) are made once per simulator. On the CPU a run
goes in chunks through the plain level chain (`fault_sim.run_chunk_plain`)
over a (G, chunk, ceil(B / 8)) uint8 table, eight samples a word, whose
level gathers copy whole contiguous rows; the last chunk is padded with
zero-fault lanes and cropped. `auto_chunk` is the reference's sizing (its
bool table under the budget); the CPU's default chunk is `packed_chunk`,
the packed table under the same budget, up to eight times the lanes a
dispatch.

Spans and counters (`runtime.trace`): `run_sites`' one-hot masks are the
span ``faults.masks``; a `run_masks` call's phases ``faults.upload``,
``faults.lanes`` and ``faults.readback`` (on the CPU also
``faults.capture``, the chunk step's set-up); the counters
``faults.lanes`` (lanes asked for, padding not counted),
``faults.upload_bytes`` (host arrays handed to the simulator's device: its
tables, masks, values and input codes) and ``faults.readback_bytes``
(the predictions brought back).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.netlist import (
    AND,
    CONST1,
    INPUT,
    NOT,
    OP_NAMES,
    OR,
    XOR,
    Circuit,
    level_gates,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import fault_sim
from repro_torch.runtime import trace

# fault-lane chunk sizing: lanes per dispatch are chosen so a chunk's value
# table stays under this budget (`auto_chunk`: the reference's (chunk, B, G)
# bool table; `packed_chunk`: the CPU's (G, chunk, ceil(B / 8)) uint8 one)
DEFAULT_CHUNK_BUDGET_BYTES = 64 << 20
MAX_CHUNK = 256


@dataclasses.dataclass(frozen=True)
class FaultSite:
    """One injectable stuck-at location.

    `gate` indexes the circuit's gate arrays; `kind` is "input" for a
    primary-input bit (op == INPUT, where `feature`/`bit` name the master
    code bit) and "gate" for a logic-gate output; `label` is the stable
    human-readable name used in fault reports."""

    gate: int
    kind: str       # "input" | "gate"
    op: str         # OP_NAMES entry ("input", "not", "and", "or", "xor")
    label: str
    feature: int = -1   # input sites only
    bit: int = -1       # input sites only


def enumerate_fault_sites(circuit: Circuit) -> list[FaultSite]:
    """Every injectable site: logic-gate outputs + primary-input bits, in
    gate-id order; CONST0/CONST1 (gates 0 and 1) are not sites."""
    sites = []
    for g in range(circuit.n_gates):
        op = int(circuit.op[g])
        if op <= CONST1:
            continue
        if op == INPUT:
            f, b = int(circuit.a[g]), int(circuit.b[g])
            sites.append(FaultSite(g, "input", "input",
                                   f"input[f{f}.b{b}]", feature=f, bit=b))
        else:
            sites.append(FaultSite(g, "gate", OP_NAMES[op],
                                   f"{OP_NAMES[op]}@{g}"))
    return sites


def site_masks(n_gates: int, gates, values) -> tuple[np.ndarray, np.ndarray]:
    """One-hot (S, G) stuck mask/value pairs for single-fault lanes."""
    gates = np.asarray(gates, np.int64)
    values = np.asarray(values)
    if gates.shape != values.shape:
        raise ValueError(
            f"gates {gates.shape} and values {values.shape} differ")
    s = gates.shape[0]
    mask = np.zeros((s, n_gates), bool)
    val = np.zeros((s, n_gates), bool)
    mask[np.arange(s), gates] = True
    val[np.arange(s), gates] = values.astype(bool)
    return mask, val


def single_fault_lanes(circuit: Circuit, sites=None):
    """(gates (2S,), values (2S,)) covering stuck-at-0 AND stuck-at-1 of
    every site: fault lane 2k is site k stuck-at-0, lane 2k+1 stuck-at-1."""
    if sites is None:
        sites = enumerate_fault_sites(circuit)
    gates = np.repeat(np.asarray([s.gate for s in sites], np.int64), 2)
    values = np.tile(np.asarray([0, 1], np.int64), len(sites))
    return gates, values


def auto_chunk(circuit: Circuit, n_samples: int,
               budget_bytes: int = DEFAULT_CHUNK_BUDGET_BYTES) -> int:
    """Fault lanes per dispatch keeping the reference's (chunk, B, G) bool
    value table under `budget_bytes` (clamped to [1, MAX_CHUNK])."""
    per_lane = max(1, int(n_samples) * circuit.n_gates)
    return int(np.clip(budget_bytes // per_lane, 1, MAX_CHUNK))


def packed_chunk(circuit: Circuit, n_samples: int,
                 budget_bytes: int = DEFAULT_CHUNK_BUDGET_BYTES) -> int:
    """Fault lanes per dispatch of `FaultSimulator.run_masks` on the CPU by
    default: its packed (G, chunk, ceil(B / 8)) uint8 value table under
    `budget_bytes` (clamped to [1, MAX_CHUNK])."""
    per_lane = max(1, -(-int(n_samples) // 8) * circuit.n_gates)
    return int(np.clip(budget_bytes // per_lane, 1, MAX_CHUNK))


class FaultSimulator:
    """Batched stuck-at simulator over one circuit's levelized schedule, on
    ``device`` (default cuda; `CudaUnavailableError` without a GPU unless
    the caller asks for the CPU).

    Each lane repeats `netlist.simulate`'s computation (same levels, same
    gathers, same boolean expressions) with one addition: after each
    level's outputs are computed, the base level included, the lane's
    stuck-at override replaces them where its mask is set, so a stuck gate
    presents its stuck value to every consumer (the standard stuck-at
    model).
    """

    def __init__(self, circuit: Circuit, device="cuda"):
        self.circuit = circuit
        self.device = dev = resolve_device(device)
        op, a, b = circuit.op, circuit.a, circuit.b
        base, levels = level_gates(circuit)

        def t(arr, dtype=torch.int64):
            out = torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype,
                                  device=dev)
            trace.count("faults.upload_bytes", out.nbytes)
            return out

        self._feat = t(np.maximum(a[base], 0))
        self._bit = t(np.maximum(b[base], 0), torch.int32)
        self._base_ops = t(op[base])[None, :]
        if dev.type == "cuda":
            self._tables = fault_sim.fault_tables(
                op, a, b, circuit.out_bits, base, levels,
                lambda arr: t(arr, torch.int32))
            return
        order = np.concatenate([base, *levels])
        row = np.empty(circuit.n_gates, np.int64)  # table row of each gate
        row[order] = np.arange(circuit.n_gates)
        self._order = t(order)
        self._levels = []   # (lo, hi, a rows, b rows, is NOT, AND, OR)
        lo = len(base)
        for idx in levels:
            ops = op[idx][:, None, None]
            self._levels.append((
                lo, lo + idx.size, t(row[a[idx]]),
                t(row[np.maximum(b[idx], 0)]), t(ops == NOT, torch.bool),
                t(ops == AND, torch.bool), t(ops == OR, torch.bool)))
            lo += idx.size
        self._out_rows = t(row[list(circuit.out_bits)])
        self._out_shift = t(np.arange(len(circuit.out_bits))[:, None, None],
                            torch.int32)
        self._bit_shift = t(np.arange(8), torch.uint8)

    def _pack(self, bits: torch.Tensor) -> torch.Tensor:
        """(..., B) bool -> (..., ceil(B / 8)) uint8, sample 8w + j at bit
        j of word w."""
        b = bits.shape[-1]
        words = -(-b // 8)
        padded = torch.nn.functional.pad(bits.to(torch.uint8),
                                         (0, 8 * words - b))
        return (padded.view(*bits.shape[:-1], words, 8)
                << self._bit_shift).sum(-1, dtype=torch.uint8)

    def _base_bits(self, x8: torch.Tensor) -> torch.Tensor:
        """(n_base, B) bool fault-free values of the inputs and
        constants."""
        in_vals = ((x8[:, self._feat] >> self._bit[None, :]) & 1).to(
            torch.bool)
        return torch.where(self._base_ops == INPUT, in_vals,
                           self._base_ops == CONST1).T

    def _run_chunk(self, vals, base_rows, mask, val, cls) -> None:
        """One chunk of the CPU's chain (`fault_sim.run_chunk_plain`):
        ``vals`` (G, chunk, W) packed table, ``mask`` (G, chunk, 1) bool
        and ``val`` (G, chunk, 1) words of 0s or 1s, the stuck overrides in
        table order; ``cls`` (chunk, B) int32 receives the predicted
        classes."""
        fault_sim.run_chunk_plain(vals, base_rows, mask, val, cls,
                                  self._levels, self._out_rows,
                                  self._out_shift, self._bit_shift)

    # -- batched campaigns -------------------------------------------------
    def run_masks(self, x8, stuck_mask, stuck_val,
                  chunk: int | None = None) -> np.ndarray:
        """(S, G) stuck masks/values -> (S, B) int32 predictions.

        On the card the lanes run in one launch of `fault_sim.fault_lanes`,
        or in launches of `chunk` lanes where one is given. On the CPU they
        run in chunks of `chunk` (by default `packed_chunk`: the value table
        under the memory budget); the final chunk pads with zero-fault
        lanes and crops. The lanes are queued back to back and read once at
        the end.
        """
        dev = self.device
        stuck_mask = np.asarray(stuck_mask, bool)
        stuck_val = np.asarray(stuck_val, bool)
        g = self.circuit.n_gates
        if stuck_mask.ndim != 2 or stuck_mask.shape[1] != g:
            raise ValueError(
                f"stuck masks must be (S, {g}), got {stuck_mask.shape}")
        if stuck_val.shape != stuck_mask.shape:
            raise ValueError(
                f"stuck values {stuck_val.shape} do not match masks "
                f"{stuck_mask.shape}")
        s, n_b = stuck_mask.shape[0], len(x8)
        if s == 0:
            return np.zeros((0, n_b), np.int32)
        trace.count("faults.lanes", s)
        if dev.type == "cuda":
            preds = self._run_card(x8, stuck_mask, stuck_val, chunk)
        else:
            preds = self._run_cpu(x8, stuck_mask, stuck_val, chunk)
        with trace.span("faults.readback"):
            out = preds[:s].cpu().numpy()
        trace.count("faults.readback_bytes", out.nbytes)
        return out

    def _run_card(self, x8, stuck_mask, stuck_val, chunk):
        """(S, B) int32 classes on the card: the masks and values uploaded
        as they are, then `fault_sim.fault_lanes` over them."""
        dev = self.device
        s, n_b = stuck_mask.shape[0], len(x8)
        with trace.span("faults.upload"):
            x8 = to_device(x8, dev).to(torch.int32)
            trace.count("faults.upload_bytes",
                        stuck_mask.nbytes + stuck_val.nbytes)
            mask_t = torch.as_tensor(np.ascontiguousarray(stuck_mask),
                                     device=dev)
            val_t = torch.as_tensor(np.ascontiguousarray(stuck_val),
                                    device=dev)
            base = fault_sim.pack_words(self._base_bits(x8))
        step = s if chunk is None else max(1, int(chunk))
        preds = torch.empty((s, n_b), dtype=torch.int32, device=dev)
        with trace.span("faults.lanes"):
            for lo in range(0, s, step):
                fault_sim.fault_lanes(base, self._tables,
                                      mask_t[lo:lo + step],
                                      val_t[lo:lo + step], n_b,
                                      out=preds[lo:lo + step])
        return preds

    def _run_cpu(self, x8, stuck_mask, stuck_val, chunk):
        """(s_pad, B) int32 classes on the CPU, in chunks of the plain
        chain over one packed table."""
        dev = self.device
        g = self.circuit.n_gates
        s, n_b = stuck_mask.shape[0], len(x8)
        if chunk is None:
            chunk = packed_chunk(self.circuit, n_b)
        chunk = max(1, min(int(chunk), s))
        s_pad = -(-s // chunk) * chunk

        def table_order(m):   # (S, G) -> (G, s_pad), zero-fault padding
            out = torch.zeros((g, s_pad), dtype=torch.bool, device=dev)
            out[:, :s] = torch.as_tensor(m, device=dev).index_select(
                1, self._order).T
            return out

        with trace.span("faults.upload"):
            x8 = to_device(x8, dev).to(torch.int32)
            trace.count("faults.upload_bytes",
                        stuck_mask.nbytes + stuck_val.nbytes)
            mask_t = table_order(stuck_mask)
            val_t = table_order(stuck_val).to(torch.uint8) * 255
            base_rows = self._pack(self._base_bits(x8))[:, None, :]
        with trace.span("faults.capture"):
            step = self._chunk_step(base_rows, chunk, n_b)
        preds = torch.empty((s_pad, n_b), dtype=torch.int32, device=dev)
        with trace.span("faults.lanes"):
            for lo in range(0, s_pad, chunk):
                step(mask_t[:, lo:lo + chunk, None],
                     val_t[:, lo:lo + chunk, None], preds[lo:lo + chunk])
        return preds

    def _chunk_step(self, base_rows, chunk: int, n_b: int):
        """``step(mask, val, cls)``: one chunk through `_run_chunk` over one
        value table."""
        vals = torch.empty((self.circuit.n_gates, chunk, -(-n_b // 8)),
                           dtype=torch.uint8, device=self.device)
        return lambda mask, val, cls: self._run_chunk(vals, base_rows, mask,
                                                      val, cls)

    def run_sites(self, x8, gates, values,
                  chunk: int | None = None) -> np.ndarray:
        """Single-fault lanes: (S,) site gates + stuck values -> (S, B)."""
        with trace.span("faults.masks"):
            mask, val = site_masks(self.circuit.n_gates, gates, values)
        return self.run_masks(x8, mask, val, chunk=chunk)

    def run_zero_fault(self, x8) -> np.ndarray:
        """(B,) predictions of the defect-free lane; equal to
        `netlist.simulate` (the mask is empty, so the levelized program
        computes the same booleans)."""
        empty = np.zeros((1, self.circuit.n_gates), bool)
        return self.run_masks(x8, empty, empty, chunk=1)[0]


def to_device(x, device) -> torch.Tensor:
    """``x`` as a tensor on ``device``. Where that hands a host array over
    (anything but a tensor already there), its bytes count in
    ``faults.upload_bytes``."""
    out = torch.as_tensor(x, device=device)
    if out is not x:
        trace.count("faults.upload_bytes", out.nbytes)
    return out


def simulate_faulty_serial(circuit: Circuit, x8, faults=()) -> np.ndarray:
    """Serial per-gate oracle: (B,) int32 predictions under `faults`.

    `faults` is an iterable of (gate, stuck_value) pairs. Evaluates gates
    one at a time in topological order with plain numpy: the reference
    the batched `FaultSimulator` is held to, sharing no torch code with
    it.
    """
    x8 = np.asarray(x8, np.int64)
    n_b = x8.shape[0]
    op, a, b = circuit.op, circuit.a, circuit.b
    stuck = {int(g): bool(v) for g, v in faults}
    vals = np.zeros((circuit.n_gates, n_b), bool)
    for g in range(circuit.n_gates):
        o = int(op[g])
        if o == CONST1:
            v = np.ones(n_b, bool)
        elif o == INPUT:
            v = ((x8[:, int(a[g])] >> int(b[g])) & 1).astype(bool)
        elif o == NOT:
            v = ~vals[int(a[g])]
        elif o == AND:
            v = vals[int(a[g])] & vals[int(b[g])]
        elif o == OR:
            v = vals[int(a[g])] | vals[int(b[g])]
        elif o == XOR:
            v = vals[int(a[g])] ^ vals[int(b[g])]
        else:               # CONST0
            v = np.zeros(n_b, bool)
        if g in stuck:
            v = np.full(n_b, stuck[g])
        vals[g] = v
    cls = np.zeros(n_b, np.int32)
    for i, w in enumerate(circuit.out_bits):
        cls |= vals[w].astype(np.int32) << i
    return cls
