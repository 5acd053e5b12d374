"""Faults layer (`core/faults.py`, `search/robustness.py`): device
milliseconds (the union of the card's activity) per 1,000 lanes in the
traced campaign."""


def read(record):
    trace = record.get("trace")
    if record["kind"] != "faults" or not trace:
        return None
    return trace["busy_s"] * 1e3 / (record["traced_lanes"] / 1e3)
