"""Faults layer (`FaultSimulator.run_masks`, `search/robustness.py`): bytes
of predictions brought back to the host (the counter
`faults.readback_bytes`, the oracle's classes included) per lane run
(`faults.lanes`) in the traced campaign."""
from perfbench import spans


def read(record):
    return spans.ratio(record, "faults", "faults.readback_bytes",
                       "faults.lanes")
