"""Fault lanes simulated per second in the fault cells: the zero-fault
lane, both stuck values of every site and the Monte-Carlo trials of every
campaign completed in the window, over the whole window."""


def read(record):
    if record["kind"] != "faults":
        return None
    return record["lanes"] / record["window_s"]
