"""Faults layer (`core/faults.py::site_masks`, `FaultSimulator.run_masks`,
`search/robustness.py`): host milliseconds of a traced campaign spent
building the (S, G) stuck masks and values in numpy and handing them,
with the input codes, to the device: the self time of the spans
`faults.masks` and `faults.upload`, over the `faults.campaign` calls."""
from perfbench import spans


def read(record):
    return spans.summed_per_call(record, "faults",
                                 ("faults.masks", "faults.upload"),
                                 "self_ms", "faults.campaign")
