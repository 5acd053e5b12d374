"""Seconds from the process's start to the first timed call: imports,
the inputs (trained on the first run of a checkout, then read from its
cache), building the kernels on a first run, the problem and its warm-up
(the first chunk's graph capture, or the campaign's shapes)."""


def read(record):
    return record["setup_s"]
