"""What one call of a step costs a rank: FLOPs, bytes, collectives, memory.

The counterpart of `repro.launch.hlo_analysis`, which parses a compiled
step's HLO. The port has no HLO: `analyze(fn, *args)` runs ``fn`` once
and watches every op it dispatches, so every op counts at its true
multiplicity (remat's recompute, each microbatch, each layer) and there
is no loop trip count to recover. It returns `hlo_analysis.analyze`'s
keys and a record of the memory:

- ``flops``: `torch.utils.flop_counter.FlopCounterMode`'s count (matmuls,
  convolutions; elementwise work is not counted, as the HLO count takes
  only dots) plus what the hand-written kernels report
  (`kernels._build.report_flops`, by kernel in ``kernel_flops``);
- ``bytes``: the HBM-traffic proxy of `hlo_analysis` (its op-result rule):
  the results of at least 1 MiB of the dispatched ops that write memory
  (views and the ``empty`` allocators excepted);
- ``collectives``: per JAX kind name (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``) the count
  and the bytes of the results (`core.comm.COLLECTIVE_RESULT_BYTES`, the
  JAX dry run's ``collective_stats`` convention), with ``sent_bytes``
  (what the rank handed to the transport, `core.comm.COLLECTIVE_BYTES`),
  and ``total_bytes``;
- ``memory``: ``argument_bytes`` (the storages of ``args``' tensors),
  ``output_bytes`` (the result's storages that are new), ``alias_bytes``
  (the result's storages that are the arguments': the in-place
  optimizer's state), ``peak_bytes`` (the most bytes of storage alive at
  once, the arguments included) and ``temp_bytes`` (the peak less the
  arguments and the new outputs).

Memory is counted by storage: an op's result whose storage is neither an
input's nor seen before is an allocation of its ``nbytes``, freed when the
storage dies. On meta tensors that is what the card would allocate, less
the caching allocator's rounding and cuBLAS's workspace, which no op
dispatches.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import pytree
from repro_torch.core import comm
from repro_torch.kernels import _build

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
JAX_KIND = {"all_gather": "all-gather", "all_reduce": "all-reduce",
            "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}
BYTES_FLOOR = 1 << 20     # hlo_analysis: results of at least 1 MiB


def _tensors(tree) -> list:
    return [t for t in pytree.leaves(tree) if isinstance(t, torch.Tensor)]


def _storages(tensors) -> dict:
    """{id: storage} of the tensors' storages, one entry each."""
    out = {}
    for t in tensors:
        st = t.untyped_storage()
        out[id(st)] = st
    return out


class _Tracker(TorchDispatchMode):
    """Live and peak storage bytes, and the 1 MiB result bytes, of the ops
    dispatched under it."""

    def __init__(self, args_storages: dict):
        super().__init__()
        self.known = WeakIdKeyDictionary()
        for st in args_storages.values():
            self.known[st] = True
        self.live = self.peak = sum(st.nbytes()
                                    for st in args_storages.values())
        self.bytes = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        name = func._schema.name.split("::")[-1]
        outs = [t for t in torch.utils._pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if not name.startswith(("empty", "new_empty")):
            self.bytes += sum(n for n in (t.numel() * t.element_size()
                                          for t in outs) if n >= BYTES_FLOOR)
        ins = _storages(t for t in torch.utils._pytree.tree_leaves(
            (args, kwargs)) if isinstance(t, torch.Tensor))
        for t in outs:
            st = t.untyped_storage()
            if id(st) in ins or st in self.known:
                continue
            self.known[st] = True
            n = st.nbytes()
            self.live += n
            weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def _counters() -> tuple:
    return (dict(comm.COLLECTIVES), dict(comm.COLLECTIVE_RESULT_BYTES),
            dict(comm.COLLECTIVE_BYTES))


def collective_stats(before: tuple) -> dict:
    """The collectives this process issued since ``before`` (`_counters`),
    by JAX kind: each kind's count, result bytes and sent bytes, and the
    result bytes of all (``total_bytes``)."""
    out = {k: {"count": 0, "bytes": 0, "sent_bytes": 0} for k in COLLECTIVES}
    for kind, name in JAX_KIND.items():
        out[name] = {key: now[kind] - then[kind] for key, now, then in zip(
            ("count", "bytes", "sent_bytes"), _counters(), before)}
    out["total_bytes"] = sum(v["bytes"] for v in out.values())
    return out


def analyze(fn, *args) -> dict:
    """Run ``fn(*args)`` once and return what it cost this rank (see the
    module docstring). Works on any device; on meta tensors nothing is
    computed and the kernels' meta branches report their FLOPs."""
    kernel_flops: dict = {}

    def sink(kernel: str, flops: int) -> None:
        kernel_flops[kernel] = kernel_flops.get(kernel, 0) + flops

    arg_st = _storages(_tensors(args))
    before = _counters()
    counter = FlopCounterMode(display=False)
    tracker = _Tracker(arg_st)
    _build.FLOP_SINKS.append(sink)
    try:
        with counter, tracker:
            result = fn(*args)
    finally:
        _build.FLOP_SINKS.remove(sink)
    out_st = _storages(_tensors(result))
    del result
    argument = sum(st.nbytes() for st in arg_st.values())
    alias = sum(st.nbytes() for i, st in out_st.items() if i in arg_st)
    output = sum(st.nbytes() for i, st in out_st.items() if i not in arg_st)
    return {
        "flops": counter.get_total_flops() + sum(kernel_flops.values()),
        "kernel_flops": kernel_flops,
        "bytes": tracker.bytes,
        "collectives": collective_stats(before),
        "memory": {"argument_bytes": argument, "output_bytes": output,
                   "alias_bytes": alias, "peak_bytes": tracker.peak,
                   "temp_bytes": tracker.peak - argument - output},
    }
