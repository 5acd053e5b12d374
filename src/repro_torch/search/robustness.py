"""Robustness campaigns over Pareto artifacts, on torch (DESIGN.md §17).

The counterpart of `repro.search.robustness`: for each Pareto point, what
accuracy survives fabrication defects? Three metrics per point:

  - **exhaustive single stuck-at**: every fault site x {stuck-0, stuck-1}
    re-classifies the full test split (`core.faults.FaultSimulator` on the
    campaign's device), reported as the mean/worst accuracy and drop vs
    the defect-free design;
  - **Monte-Carlo defect draws**: `n_trials` iid gate-defect masks at
    `defect_rate` per site, stuck polarity a fair coin;
  - **critical-gate ranking**: sites ordered by their worst-polarity
    accuracy drop.

torch cannot replay the reference's `jax.random.fold_in` keys, so the
Monte-Carlo draw is split from its metric: `draw_defects` gives trial `t`
its own CPU `torch.Generator`, seeded from `(seed, t)`, so a seed
reproduces every mask on any device and trial `t`'s mask does not depend
on `n_trials`; `monte_carlo_metrics` scores any (T, S) hit/polarity masks,
JAX's included. Accuracies and their reductions are float64 numpy on the
host from the (S, B) predictions, as in the reference, so a report equals
the JAX package's in every key but `monte_carlo` (and `source`).

A campaign (`point_robustness`) is the span ``faults.campaign``
(`runtime.trace`); its host phases are ``faults.simulator`` (building the
simulator), ``faults.oracle`` (`netlist.simulate` and its read back),
``faults.draws``, ``faults.masks`` (the sites and the (S, G) masks built in
numpy) and ``faults.reduce`` (the accuracies and the ranking), beside the
simulator's own.

`fault_report.json` keeps the reference's schema and its two-sided key
discipline: `validate_fault_report` rejects missing AND unknown keys with a
named `ValueError`, on write and on load.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.core import faults, netlist
from repro_torch.runtime import trace

DEFAULT_DEFECT_RATE = 0.02
DEFAULT_TRIALS = 32
DEFAULT_TOP_K = 10
DEFAULT_MC_SEED = 0

# fault_report.json writer/loader contract (the reference's sets: the
# schema may only grow by extending them; both directions are errors)
REQUIRED_TOP_KEYS = frozenset({
    "source", "dataset", "family", "n_classes", "n_samples",
    "defect_rate", "n_trials", "mc_seed", "top_k", "points",
})
OPTIONAL_TOP_KEYS = frozenset({"max_loss"})
REQUIRED_POINT_KEYS = frozenset({
    "point", "acc_loss", "norm_area", "area_mm2", "n_gates", "n_sites",
    "n_faults", "baseline_accuracy", "recorded_accuracy",
    "zero_fault_matches_simulate", "single_fault", "critical_gates",
    "monte_carlo",
})
REQUIRED_SINGLE_FAULT_KEYS = frozenset({
    "mean_accuracy", "worst_accuracy", "mean_drop", "worst_drop",
})
REQUIRED_MC_KEYS = frozenset({
    "expected_accuracy", "std_accuracy", "worst_accuracy",
    "mean_faulty_sites",
})
REQUIRED_CRITICAL_KEYS = frozenset({
    "gate", "label", "kind", "drop", "stuck_value",
})


def _check_keys(have, required, optional, where: str) -> None:
    have = set(have)
    missing = sorted(required - have)
    unknown = sorted(have - required - optional)
    problems = []
    if missing:
        problems.append(f"missing keys {missing}")
    if unknown:
        problems.append(f"unknown keys {unknown}")
    if problems:
        raise ValueError(
            f"fault report {where}: {'; '.join(problems)} "
            f"(expected {sorted(required)} + optional {sorted(optional)})")


def validate_fault_report(payload: dict, where: str = "payload") -> dict:
    """Two-sided schema check for a fault_report.json payload.

    Missing and unknown keys both raise a named `ValueError` (top level,
    per point, and the nested single_fault / monte_carlo / critical_gates
    records), plus the campaign invariants: `n_faults == 2 * n_sites` and
    a zero-fault lane that matched `netlist.simulate` exactly.
    """
    if not isinstance(payload, dict):
        raise ValueError(f"fault report {where}: expected a JSON object, "
                         f"got {type(payload).__name__}")
    _check_keys(payload, REQUIRED_TOP_KEYS, OPTIONAL_TOP_KEYS, where)
    if not isinstance(payload["points"], list):
        raise ValueError(f"fault report {where}: 'points' must be a list")
    for i, point in enumerate(payload["points"]):
        w = f"{where}.points[{i}]"
        if not isinstance(point, dict):
            raise ValueError(f"fault report {w}: must be an object")
        _check_keys(point, REQUIRED_POINT_KEYS, frozenset(), w)
        _check_keys(point["single_fault"], REQUIRED_SINGLE_FAULT_KEYS,
                    frozenset(), f"{w}.single_fault")
        _check_keys(point["monte_carlo"], REQUIRED_MC_KEYS, frozenset(),
                    f"{w}.monte_carlo")
        for j, cg in enumerate(point["critical_gates"]):
            _check_keys(cg, REQUIRED_CRITICAL_KEYS, frozenset(),
                        f"{w}.critical_gates[{j}]")
        if point["n_faults"] != 2 * point["n_sites"]:
            raise ValueError(
                f"fault report {w}: n_faults={point['n_faults']} is not "
                f"2 * n_sites={point['n_sites']} (stuck-0 + stuck-1 lanes)")
        if not point["zero_fault_matches_simulate"]:
            raise ValueError(
                f"fault report {w}: zero_fault_matches_simulate is false — "
                f"the fault simulator diverged from core.netlist.simulate")
    return payload


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def single_stuck_at(sim: faults.FaultSimulator, x8, y,
                    chunk: int | None = None):
    """Exhaustive single stuck-at campaign: accuracies of every fault.

    Returns (sites, accuracies) where `accuracies` is (2S,) float64 with
    lane 2k = site k stuck-at-0 and lane 2k+1 = stuck-at-1 (the lane order
    of `faults.single_fault_lanes`).
    """
    y = _host(y).astype(np.int64)
    with trace.span("faults.masks"):
        sites = faults.enumerate_fault_sites(sim.circuit)
        gates, values = faults.single_fault_lanes(sim.circuit, sites)
    preds = sim.run_sites(x8, gates, values, chunk=chunk)   # (2S, B)
    with trace.span("faults.reduce"):
        accs = (preds == y[None, :]).mean(axis=1)
    return sites, accs


def draw_defects(n_sites: int, *, defect_rate: float = DEFAULT_DEFECT_RATE,
                 n_trials: int = DEFAULT_TRIALS,
                 seed: int = DEFAULT_MC_SEED):
    """(hit, pol): (T, S) bool defect masks and stuck polarities.

    Trial `t` draws from a CPU `torch.Generator` seeded from `(seed, t)`
    alone: a seed reproduces every trial on any device, and trial `t`'s
    masks are the same whatever `n_trials` is.
    """
    hit = np.zeros((n_trials, n_sites), bool)
    pol = np.zeros((n_trials, n_sites), bool)
    for t in range(n_trials):
        state = np.random.SeedSequence((seed % 2**64, t)).generate_state(
            1, np.uint64)[0]
        gen = torch.Generator().manual_seed(int(state))
        hit[t] = (torch.rand(n_sites, generator=gen, dtype=torch.float64)
                  < defect_rate).numpy()
        pol[t] = (torch.rand(n_sites, generator=gen, dtype=torch.float64)
                  < 0.5).numpy()
    return hit, pol


def monte_carlo_metrics(sim: faults.FaultSimulator, x8, y, hit, pol,
                        chunk: int | None = None) -> dict:
    """Accuracy under the (T, S) defect masks ``hit`` (site s of trial t
    stuck at ``pol[t, s]``): the metric dict plus the per-trial accuracy
    array under "_accuracies" (stripped before serialization)."""
    y = _host(y).astype(np.int64)
    with trace.span("faults.masks"):
        sites = faults.enumerate_fault_sites(sim.circuit)
        site_gates = np.asarray([s.gate for s in sites], np.int64)
        hit = np.asarray(hit, bool)
        pol = np.asarray(pol, bool)
        mask = np.zeros((hit.shape[0], sim.circuit.n_gates), bool)
        val = np.zeros_like(mask)
        mask[:, site_gates] = hit
        val[:, site_gates] = hit & pol
    preds = sim.run_masks(x8, mask, val, chunk=chunk)       # (T, B)
    with trace.span("faults.reduce"):
        accs = (preds == y[None, :]).mean(axis=1)
        return {
            "expected_accuracy": float(accs.mean()),
            "std_accuracy": float(accs.std()),
            "worst_accuracy": float(accs.min()),
            "mean_faulty_sites": float(mask.sum(axis=1).mean()),
            "_accuracies": accs,
        }


def monte_carlo(sim: faults.FaultSimulator, x8, y, *,
                defect_rate: float = DEFAULT_DEFECT_RATE,
                n_trials: int = DEFAULT_TRIALS,
                seed: int = DEFAULT_MC_SEED,
                chunk: int | None = None) -> dict:
    """Expected accuracy under iid per-site defects (`draw_defects` under
    ``seed``, scored by `monte_carlo_metrics`)."""
    with trace.span("faults.draws"):
        hit, pol = draw_defects(
            len(faults.enumerate_fault_sites(sim.circuit)),
            defect_rate=defect_rate, n_trials=n_trials, seed=seed)
    return monte_carlo_metrics(sim, x8, y, hit, pol, chunk=chunk)


def critical_gates(sites, accs, baseline: float,
                   top_k: int = DEFAULT_TOP_K) -> list:
    """Top-k sites by worst-polarity accuracy drop, largest first.

    Ties break on gate id so the ranking is deterministic.
    """
    accs = np.asarray(accs, np.float64).reshape(-1, 2)   # (S, [sa0, sa1])
    worst_pol = accs.argmin(axis=1)                      # 0 = stuck-at-0
    drops = baseline - accs.min(axis=1)
    order = sorted(range(len(sites)), key=lambda i: (-drops[i],
                                                     sites[i].gate))
    return [{
        "gate": int(sites[i].gate),
        "label": sites[i].label,
        "kind": sites[i].kind,
        "drop": float(drops[i]),
        "stuck_value": int(worst_pol[i]),
    } for i in order[:top_k]]


def point_robustness(circuit, x8, y, *,
                     defect_rate: float = DEFAULT_DEFECT_RATE,
                     n_trials: int = DEFAULT_TRIALS,
                     seed: int = DEFAULT_MC_SEED,
                     top_k: int = DEFAULT_TOP_K,
                     chunk: int | None = None,
                     device="cuda") -> dict:
    """All three robustness metrics for one circuit on one test split, on
    ``device``.

    The returned dict carries the per-point schema fields that do not
    depend on the artifact (`run_campaign` adds point/acc_loss/norm_area/
    area_mm2/recorded_accuracy).
    """
    with trace.span("faults.campaign"):
        y = _host(y).astype(np.int64)
        with trace.span("faults.simulator"):
            sim = faults.FaultSimulator(circuit, device=device)
        zero = sim.run_zero_fault(x8)
        with trace.span("faults.oracle"):
            oracle = netlist.simulate(
                circuit, faults.to_device(x8, sim.device)).cpu().numpy()
        trace.count("faults.readback_bytes", oracle.nbytes)
        with trace.span("faults.reduce"):
            zero_ok = bool(np.array_equal(zero, oracle))
            baseline = float((zero == y).mean())
        sites, accs = single_stuck_at(sim, x8, y, chunk=chunk)
        mc = monte_carlo(sim, x8, y, defect_rate=defect_rate,
                         n_trials=n_trials, seed=seed, chunk=chunk)
        mc.pop("_accuracies")
        with trace.span("faults.reduce"):
            return {
                "n_gates": int(circuit.n_gates),
                "n_sites": len(sites),
                "n_faults": int(accs.shape[0]),
                "baseline_accuracy": baseline,
                "zero_fault_matches_simulate": zero_ok,
                "single_fault": {
                    "mean_accuracy": float(accs.mean()),
                    "worst_accuracy": float(accs.min()),
                    "mean_drop": float((baseline - accs).mean()),
                    "worst_drop": float((baseline - accs).max()),
                },
                "critical_gates": critical_gates(sites, accs, baseline,
                                                 top_k=top_k),
                "monte_carlo": mc,
            }


def select_points(artifact, point: str = "all",
                  max_loss: float = 0.01) -> list[int]:
    """Resolve a --point spec: 'all', 'best' (smallest area within
    `max_loss`), or an explicit index."""
    n = len(artifact.points)
    if point == "all":
        return list(range(n))
    if point == "best":
        best = artifact.best_under_loss(max_loss)
        if best is None:
            raise ValueError(
                f"fault campaign: no pareto point within max_loss="
                f"{max_loss} (have {n} points)")
        return [best]
    idx = int(point)
    if not -n <= idx < n:
        raise ValueError(f"fault campaign: point index {idx} out of range "
                         f"for {n} pareto points")
    return [idx % n]


def run_campaign(artifact, x8, y, *, source: str = "pareto.json",
                 dataset: str | None = None, point: str = "all",
                 max_loss: float = 0.01,
                 defect_rate: float = DEFAULT_DEFECT_RATE,
                 n_trials: int = DEFAULT_TRIALS,
                 seed: int = DEFAULT_MC_SEED,
                 top_k: int = DEFAULT_TOP_K,
                 chunk: int | None = None,
                 verbose: bool = False,
                 device="cuda") -> dict:
    """Per-Pareto-point robustness report for one artifact (any family),
    on ``device``.

    Builds each selected point's gate-level circuit through its family's
    `build_point_circuit`, runs the three campaigns of `point_robustness`,
    and returns a validated fault_report payload.
    """
    from repro_torch.families import get_family

    family = getattr(artifact, "family", "tree")
    fam = get_family(family)
    points = []
    for idx in select_points(artifact, point, max_loss):
        circuit = fam.build_point_circuit(artifact, idx)
        row = point_robustness(circuit, x8, y, defect_rate=defect_rate,
                               n_trials=n_trials, seed=seed, top_k=top_k,
                               chunk=chunk, device=device)
        pt = artifact.points[idx]
        row = {
            "point": int(idx),
            "acc_loss": float(pt["acc_loss"]),
            "norm_area": float(pt["norm_area"]),
            "area_mm2": float(pt.get("area_netlist_mm2",
                                     pt.get("area_mm2", 0.0))),
            "recorded_accuracy": float(artifact.point_accuracy(idx)),
            **row,
        }
        points.append(row)
        if verbose:
            sf = row["single_fault"]
            print(f"  point {idx}: {row['n_sites']} sites x 2 faults, "
                  f"baseline {row['baseline_accuracy']:.4f}, 1-fault "
                  f"mean {sf['mean_accuracy']:.4f} / worst "
                  f"{sf['worst_accuracy']:.4f}, MC({defect_rate:.0%}) "
                  f"{row['monte_carlo']['expected_accuracy']:.4f}")
    payload = {
        "source": source,
        "dataset": dataset if dataset is not None
        else getattr(artifact, "dataset", None),
        "family": family,
        "n_classes": int(artifact.n_classes),
        "n_samples": len(x8),
        "defect_rate": float(defect_rate),
        "n_trials": int(n_trials),
        "mc_seed": int(seed),
        "top_k": int(top_k),
        "max_loss": float(max_loss),
        "points": points,
    }
    return validate_fault_report(payload)


def write_fault_report(payload: dict, path: str) -> str:
    """Validate + atomically write a fault_report.json."""
    validate_fault_report(payload, where=path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, path)
    return path


def load_fault_report(path: str) -> dict:
    """Load + validate a fault_report.json."""
    with open(path) as f:
        payload = json.load(f)
    return validate_fault_report(payload, where=path)
