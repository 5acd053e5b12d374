"""Faults layer (`FaultSimulator.run_masks`, `search/robustness.py`): host
milliseconds of a traced campaign spent bringing the (S, B) predictions
back and reducing them in numpy (accuracies, the critical-gate ranking):
the spans `faults.readback` and `faults.reduce`, over the
`faults.campaign` calls."""
from perfbench import spans


def read(record):
    return spans.summed_per_call(
        record, "faults", ("faults.readback", "faults.reduce"), "host_ms",
        "faults.campaign")
