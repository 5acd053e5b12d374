"""The plain reference of the fault campaign: stuck-at faults simulated
over a gate netlist, in plain PyTorch.

A netlist is three arrays over gates g: op (0 const0, 1 const1, 2 input
bit, 3 NOT, 4 AND2, 5 OR2, 6 XOR2) and the operands a, b (an input gate's
a and b are the feature and the bit of its 8-bit code); gates follow their
operands; the class is the binary number on the output wires, LSB first.
The fault sites are every gate but the two constants, in gate order; a
stuck gate presents its stuck value to every consumer. Lane 2k holds site
k stuck at 0 and lane 2k+1 stuck at 1; a Monte-Carlo trial t strikes each
site with probability ``rate``, stuck at a fair coin, both drawn from a
CPU generator seeded from ``SeedSequence((seed, t))``.

The simulator packs 64 rows into an int64 word and evaluates gates by
logic level, a level's gates of one kind at a time, over a block of lanes.
"""
from __future__ import annotations

import numpy as np
import torch

CONST1, INPUT, NOT, AND, OR, XOR = 1, 2, 3, 4, 5, 6


def sites(op: np.ndarray) -> np.ndarray:
    return np.flatnonzero(op > CONST1)


def defect_draws(n_sites: int, rate: float, n_trials: int, seed: int):
    """(hit, stuck value) (T, S) bool."""
    hit = np.zeros((n_trials, n_sites), bool)
    pol = np.zeros((n_trials, n_sites), bool)
    for t in range(n_trials):
        state = np.random.SeedSequence((seed % 2 ** 64, t)).generate_state(
            1, np.uint64)[0]
        gen = torch.Generator().manual_seed(int(state))
        hit[t] = (torch.rand(n_sites, generator=gen, dtype=torch.float64)
                  < rate).numpy()
        pol[t] = (torch.rand(n_sites, generator=gen, dtype=torch.float64)
                  < 0.5).numpy()
    return hit, pol & hit


class Netlist:
    def __init__(self, op, a, b, out_bits, device, budget=2 << 30):
        self.dev = torch.device(device)
        self.op = np.asarray(op, np.int64)
        self.a = np.asarray(a, np.int64)
        self.b = np.asarray(b, np.int64)
        self.out = list(out_bits)
        self.budget = budget
        level = np.zeros(self.op.size, np.int64)
        for g in np.flatnonzero(self.op >= NOT):
            la = level[self.a[g]]
            level[g] = 1 + (la if self.op[g] == NOT
                            else max(la, level[self.b[g]]))
        self.levels = [np.flatnonzero(level == v)
                       for v in range(int(level.max()) + 1)]

    def classes(self, x8, stuck_mask, stuck_val) -> np.ndarray:
        """(L, B) int32 classes of rows ``x8`` (B, F) codes under each
        lane's (L, G) stuck mask and values."""
        dev = self.dev
        n_rows = x8.shape[0]
        words = -(-n_rows // 64)
        weights = torch.ones(64, dtype=torch.int64, device=dev) << torch.arange(
            64, device=dev)

        def pack(bits):                        # (..., B) bool -> (..., W)
            pad = torch.zeros((*bits.shape[:-1], words * 64), dtype=torch.int64,
                              device=dev)
            pad[..., :n_rows] = bits
            return (pad.view(*bits.shape[:-1], words, 64) * weights).sum(-1)

        x8 = torch.as_tensor(np.asarray(x8, np.int64), device=dev)
        fault_free = torch.zeros((self.op.size, words), dtype=torch.int64,
                                 device=dev)
        base = self.levels[0]
        inputs = base[self.op[base] == INPUT]
        fault_free[torch.as_tensor(inputs, device=dev)] = pack(
            ((x8[:, self.a[inputs]] >> torch.as_tensor(self.b[inputs],
                                                       device=dev)) & 1).T)
        fault_free[torch.as_tensor(base[self.op[base] == CONST1],
                                   device=dev)] = -1
        n_lanes = stuck_mask.shape[0]
        block = max(1, min(n_lanes, self.budget // (8 * words * self.op.size)))
        out = np.zeros((n_lanes, n_rows), np.int32)
        for lo in range(0, n_lanes, block):
            mask = torch.as_tensor(stuck_mask[lo:lo + block], device=dev).T
            val = -torch.as_tensor(stuck_val[lo:lo + block], device=dev).T.long()
            out[lo:lo + block] = self._block(fault_free, mask, val,
                                             n_rows).cpu().numpy()
        return out

    def _block(self, fault_free, mask, val, n_rows):
        dev = self.dev
        vals = fault_free[:, None, :].repeat(1, mask.shape[1], 1)
        for depth, gates in enumerate(self.levels):
            g = torch.as_tensor(gates, device=dev)
            if depth:
                kinds = self.op[gates]
                for kind in (NOT, AND, OR, XOR):
                    sel = gates[kinds == kind]
                    if sel.size == 0:
                        continue
                    av = vals[torch.as_tensor(self.a[sel], device=dev)]
                    if kind == NOT:
                        res = ~av
                    else:
                        bv = vals[torch.as_tensor(self.b[sel], device=dev)]
                        res = (av & bv if kind == AND else
                               av | bv if kind == OR else av ^ bv)
                    vals[torch.as_tensor(sel, device=dev)] = res
            vals[g] = torch.where(mask[g][..., None], val[g][..., None], vals[g])
        cls = torch.zeros((mask.shape[1], n_rows), dtype=torch.int64, device=dev)
        shifts = torch.arange(64, device=dev)
        for i, wire in enumerate(self.out):
            bits = ((vals[wire][..., None] >> shifts) & 1).flatten(1)[:, :n_rows]
            cls |= bits << i
        return cls.to(torch.int32)


def campaign(netlist: Netlist, x8, y, *, rate: float, n_trials: int,
             seed: int, top_k: int = 10) -> dict:
    """The campaign's classes and figures: every row's class in the
    zero-fault lane (1, B), the single-fault lanes (2S, B) and the
    Monte-Carlo trials (T, B); the zero-fault accuracy and the single
    lanes' accuracies reduced as a fault report reduces them (float64, lane
    order), the top ``top_k`` sites by worst drop (ties by gate), and the
    trials' accuracies."""
    y = np.asarray(y, np.int64)
    n_rows = x8.shape[0]
    site = sites(netlist.op)
    n_gates = netlist.op.size
    lanes = 2 * site.size
    mask = np.zeros((1 + lanes, n_gates), bool)
    val = np.zeros_like(mask)
    mask[1 + np.arange(lanes), np.repeat(site, 2)] = True
    val[1 + np.arange(lanes), np.repeat(site, 2)] = np.tile([False, True],
                                                            site.size)
    single = netlist.classes(x8, mask, val)
    counts = (single == y).sum(1)
    baseline = counts[0] / n_rows
    accs = counts[1:] / n_rows
    pairs = accs.reshape(-1, 2)
    drops = baseline - pairs.min(axis=1)
    order = sorted(range(site.size), key=lambda i: (-drops[i], site[i]))
    hit, stuck = defect_draws(site.size, rate, n_trials, seed)
    mc_mask = np.zeros((n_trials, n_gates), bool)
    mc_val = np.zeros_like(mc_mask)
    mc_mask[:, site], mc_val[:, site] = hit, stuck
    trials = netlist.classes(x8, mc_mask, mc_val)
    mc = (trials == y).sum(1) / n_rows
    return {
        "classes": {"zero": single[:1], "single": single[1:],
                    "trials": trials},
        "n_sites": int(site.size),
        "baseline_accuracy": float(baseline),
        "single_fault": {
            "mean_accuracy": float(accs.mean()),
            "worst_accuracy": float(accs.min()),
            "mean_drop": float((baseline - accs).mean()),
            "worst_drop": float((baseline - accs).max()),
        },
        "critical_gates": [(int(site[i]), float(drops[i]),
                            int(pairs[i].argmin())) for i in order[:top_k]],
        "monte_carlo": {
            "expected_accuracy": float(mc.mean()),
            "std_accuracy": float(mc.std()),
            "worst_accuracy": float(mc.min()),
            "mean_faulty_sites": float(mc_mask.sum(axis=1).mean()),
        },
    }
