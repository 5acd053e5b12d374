"""Faults layer (`core/faults.py`, `search/robustness.py::point_robustness`):
host milliseconds of a traced campaign spent on what every campaign
builds anew: the simulator and its index tables (`faults.simulator`),
the chunk graphs of its three `run_masks` calls (`faults.capture`) and
the `netlist.simulate` oracle (`faults.oracle`), over the
`faults.campaign` calls."""
from perfbench import spans


def read(record):
    return spans.summed_per_call(
        record, "faults",
        ("faults.simulator", "faults.capture", "faults.oracle"), "host_ms",
        "faults.campaign")
