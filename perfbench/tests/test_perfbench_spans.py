"""`perfbench.spans` on hand-made spans (calls, host time, self time under
nesting and repetition), on what the program itself records under a
profiler, and the new readers on hand-made records: each reads what the
record and the program's record of the stretch give, and returns None
where the run was not traced, is of the other kind, or the program
recorded nothing."""
from __future__ import annotations

import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import harness, spans
from perfbench.tests.layout import REPO
from repro_torch import runtime
from repro_torch.runtime import trace

MS = 1e-6    # a nanosecond in milliseconds

MARKS = [  # (name, start, end), in order of their end as the program keeps
    ("a.b", 150, 300), ("a.c.d", 330, 340), ("a.c", 320, 480),
    ("a", 100, 500), ("z.y", 600, 700), ("z", 600, 900),
]


def test_spans_calls_host_and_self():
    got = spans.reduce(MARKS)
    want = {  # calls, host, self (ns)
        "a": (1, 400, 400 - 150 - 160),
        "a.b": (1, 150, 150),
        "a.c": (1, 160, 150),
        "a.c.d": (1, 10, 10),
        "z": (1, 300, 200),
        "z.y": (1, 100, 100),
    }
    assert set(got) == set(want)
    for name, (calls, host, own) in want.items():
        assert got[name] == {"calls": calls,
                             "host_ms": pytest.approx(host * MS),
                             "self_ms": pytest.approx(own * MS)}, name


def test_repeated_and_touching_spans_sum_apart():
    got = spans.reduce([("s", 0, 10), ("s", 10, 30), ("t", 30, 31)])
    assert got["s"] == {"calls": 2, "host_ms": pytest.approx(30 * MS),
                        "self_ms": pytest.approx(30 * MS)}
    assert got["t"]["self_ms"] == pytest.approx(1 * MS)


def test_no_spans_gives_nothing():
    assert spans.reduce([]) == {}


def test_the_program_records_the_profiled_stretch_alone():
    trace.forget()
    with trace.span("faults.campaign"):
        trace.count("faults.lanes", 5)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("faults.campaign"):
            with trace.span("faults.lanes"):
                torch.ones(3).add_(1)
            trace.count("faults.lanes", 7)
    seen = spans.recorded()
    trace.forget()
    assert seen["counts"] == {"faults.lanes": 7}
    got = spans.reduce(seen["spans"])
    assert {n: s["calls"] for n, s in got.items()} == {
        "faults.campaign": 1, "faults.lanes": 1}
    assert got["faults.campaign"]["self_ms"] <= got["faults.campaign"][
        "host_ms"]


def reader(name):
    return harness.load_module(REPO / "perfbench/metrics" / f"{name}.py")


RNG = "at::native::anon::distribution_elementwise_grid_stride_kernel<float"


def _marks(names_calls_ms):
    """Spans one after another: (name, calls, ms each) -> marks."""
    out, t = [], 0
    for name, calls, ms in names_calls_ms:
        for _ in range(calls):
            out.append((name, t, t + int(ms * 1e6)))
            t += int(ms * 1e6)
    return out


SEARCH = {"kind": "search", "traced_generations": 120,
          "shape": {"pop": 512},
          "trace": {"busy_s": 0.1, "window_s": 0.12,
                    "kernels": {RNG: [0.0021, 700],
                                "anon::fitness_mma_kernel": [0.05, 100]}}}
SEARCH_SEEN = {"spans": _marks([("nsga2.chunk.draw", 3, 3.0)]),
               "counts": {"nsga2.evaluations": 120 * 512,
                          "nsga2.draws": 3 * 280}}
# a campaign of 700 ms: its children, then itself around them
CAMPAIGN = [("faults.simulator", 1, 4.0), ("faults.upload", 3, 60.0),
            ("faults.masks", 3, 10.0), ("faults.capture", 3, 5.0),
            ("faults.oracle", 1, 3.0), ("faults.readback", 3, 15.0),
            ("faults.reduce", 4, 5.0)]
FAULTS = {"kind": "faults", "traced_lanes": 5441,
          "trace": {"busy_s": 0.1, "window_s": 0.7, "kernels": {}}}
FAULTS_SEEN = {"spans": _marks(CAMPAIGN) + [("faults.campaign", 0, 700e6)],
               "counts": {"faults.lanes": 5441,
                          "faults.upload_bytes": 36_400_000,
                          "faults.readback_bytes": 67_263_120,
                          "graphs.captures": 3}}


@pytest.mark.parametrize("name,record,seen,want", [
    ("draw_device_ms", SEARCH, SEARCH_SEEN, 0.0021e3 / 700 * 280),
    ("draw_device_ms.mlp", SEARCH, SEARCH_SEEN, 0.0021e3 / 700 * 280),
    ("fitness_evals_share", SEARCH, SEARCH_SEEN, 1.0),
    ("fitness_evals_share.mlp", SEARCH, SEARCH_SEEN, 1.0),
    ("fault_masks_host_ms", FAULTS, FAULTS_SEEN, 3 * 60.0 + 3 * 10.0),
    ("fault_readback_host_ms", FAULTS, FAULTS_SEEN, 3 * 15.0 + 4 * 5.0),
    ("fault_rebuild_host_ms", FAULTS, FAULTS_SEEN, 4.0 + 3 * 5.0 + 3.0),
    ("fault_upload_bytes_per_lane", FAULTS, FAULTS_SEEN, 36_400_000 / 5441),
    ("fault_readback_bytes_per_lane", FAULTS, FAULTS_SEEN,
     67_263_120 / 5441),
    ("fault_captures_per_campaign", FAULTS, FAULTS_SEEN, 3.0),
])
def test_reader_reads_the_record(monkeypatch, name, record, seen, want):
    monkeypatch.setattr(spans, "recorded", lambda: seen)
    assert reader(name).read(record) == pytest.approx(want)


def test_a_campaign_per_call_divides_by_its_calls(monkeypatch):
    later = [(n, a + 10**9, b + 10**9) for n, a, b in FAULTS_SEEN["spans"]]
    two = {"spans": FAULTS_SEEN["spans"] + later,
           "counts": {k: 2 * n for k, n in FAULTS_SEEN["counts"].items()}}
    monkeypatch.setattr(spans, "recorded", lambda: two)
    assert reader("fault_masks_host_ms").read(FAULTS) == pytest.approx(210.0)
    assert reader("fault_captures_per_campaign").read(FAULTS) == 3.0
    assert (reader("fault_upload_bytes_per_lane").read(FAULTS)
            == pytest.approx(36_400_000 / 5441))


NAMES = ["draw_device_ms", "draw_device_ms.mlp", "fitness_evals_share",
         "fitness_evals_share.mlp", "fault_masks_host_ms",
         "fault_readback_host_ms", "fault_rebuild_host_ms",
         "fault_upload_bytes_per_lane", "fault_readback_bytes_per_lane",
         "fault_captures_per_campaign"]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seen", [
    None, {"spans": [], "counts": {}}], ids=["older", "silent"])
def test_reader_is_none_where_the_program_records_nothing(monkeypatch, name,
                                                          seen):
    monkeypatch.setattr(spans, "recorded", lambda: seen)
    for base in (SEARCH, FAULTS):
        assert reader(name).read(base) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_is_none_untraced_or_in_the_other_kind(monkeypatch, name):
    both = {"spans": SEARCH_SEEN["spans"] + FAULTS_SEEN["spans"],
            "counts": {**SEARCH_SEEN["counts"], **FAULTS_SEEN["counts"]}}
    monkeypatch.setattr(spans, "recorded", lambda: both)
    for base in (SEARCH, FAULTS):
        assert reader(name).read({**base, "trace": None}) is None
    other = FAULTS if name.startswith(("draw", "fitness")) else SEARCH
    assert reader(name).read(other) is None


def test_draws_need_their_kernels(monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: SEARCH_SEEN)
    record = {**SEARCH, "trace": {**SEARCH["trace"], "kernels": {
        "anon::fitness_mma_kernel": [0.05, 100]}}}
    assert reader("draw_device_ms").read(record) is None


def test_an_older_program_has_no_record(monkeypatch):
    """A program with no `repro_torch.runtime.trace` (the parent of the
    spans) has nothing to read."""
    monkeypatch.delattr(runtime, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
    assert spans.recorded() is None
