"""Faults layer (`core/faults.py`, `search/robustness.py`): bytes of host
arrays handed to the simulator's device (the counter
`faults.upload_bytes`: masks, values, input codes, the index tables) per
lane run (`faults.lanes`) in the traced campaign."""
from perfbench import spans


def read(record):
    return spans.ratio(record, "faults", "faults.upload_bytes",
                       "faults.lanes")
