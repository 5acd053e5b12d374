"""The source paper's published per-dataset results (Tables I and II).

The counterpart of `repro.datasets.paper_refs`, copied so that the port
imports nothing of the JAX package: the scoring targets of the full-suite
sweep (`repro_torch.search.sweep.write_sweep_report`).

The paper's areas and powers are Synopsys-DC/EGT-PDK measurements; the
repo's area model is gate-count based and calibrated to the same
magnitudes, so the per-dataset normalized quantities (Table II) are the
meaningful comparison and absolute mm^2 are order-of-magnitude checks.
"""
from __future__ import annotations

# dataset: (accuracy, n_comparators, delay_ms, area_mm2, power_mw)
PAPER_TABLE1: dict[str, tuple[float, int, float, float, float]] = {
    "arrhythmia": (0.564, 54, 27.0, 162.50, 7.55),
    "balance": (0.745, 102, 28.0, 68.04, 3.11),
    "cardio": (0.928, 79, 30.4, 178.63, 8.12),
    "har": (0.835, 178, 33.7, 551.08, 26.10),
    "mammographic": (0.759, 150, 34.2, 98.75, 4.47),
    "pendigits": (0.968, 243, 36.9, 574.46, 25.00),
    "redwine": (0.600, 259, 38.7, 513.84, 22.30),
    "seeds": (0.889, 10, 20.3, 30.13, 1.43),
    "vertebral": (0.850, 27, 20.9, 57.70, 2.68),
    "whitewine": (0.617, 280, 49.9, 543.12, 23.20),
}

# dataset: (normalized area, normalized power) of the paper's selected
# approximate design at the 1% accuracy-loss budget (Table II)
PAPER_TABLE2_NORM: dict[str, tuple[float, float]] = {
    "arrhythmia": (0.137, 0.138), "balance": (0.401, 0.372),
    "cardio": (0.244, 0.253), "har": (0.534, 0.525),
    "mammographic": (0.082, 0.084), "pendigits": (0.641, 0.644),
    "redwine": (0.520, 0.525), "seeds": (0.077, 0.064),
    "vertebral": (0.136, 0.142), "whitewine": (0.229, 0.230),
}

# cross-dataset means the paper headlines at the 1% budget
PAPER_MEAN_AREA_REDUCTION_1PCT = 3.2
PAPER_MEAN_POWER_REDUCTION_1PCT = 3.4
