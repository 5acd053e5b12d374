"""Faults layer (`core/faults.py`, `kernels/fault_sim.py`): launches of
the fault-lane kernel (the counter `launches.fault_lanes`) per traced
campaign (`faults.campaign` calls); none where the program has no such
kernel."""
from perfbench import spans


def read(record):
    launches = spans.counted(record, "faults", "launches.fault_lanes")
    campaign = spans.span(record, "faults", "faults.campaign")
    if launches is None or campaign is None:
        return None
    return launches / campaign["calls"]
