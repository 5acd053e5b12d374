"""`fault_launches_per_campaign` on hand-made records: the fault-lane
kernel's launches over the traced campaigns; None where the run was not
traced, is of the other kind, or the program counted no such launch."""
from __future__ import annotations

import pytest

from perfbench import harness, spans
from perfbench.tests.layout import REPO

NAME = "fault_launches_per_campaign"
FAULTS = {"kind": "faults", "traced_lanes": 5441,
          "trace": {"busy_s": 0.01, "window_s": 0.2, "kernels": {}}}
SEARCH = {"kind": "search", "traced_generations": 120,
          "shape": {"pop": 512},
          "trace": {"busy_s": 0.1, "window_s": 0.12, "kernels": {}}}


def _seen(campaigns: int, launches: int | None) -> dict:
    marks = [("faults.campaign", i * 10**9, i * 10**9 + 2 * 10**8)
             for i in range(campaigns)]
    counts = {"faults.lanes": 5441 * campaigns}
    if launches is not None:
        counts["launches.fault_lanes"] = launches
    return {"spans": marks, "counts": counts}


def reader():
    return harness.load_module(REPO / "perfbench/metrics" / f"{NAME}.py")


@pytest.mark.parametrize("campaigns,launches,want", [
    (1, 3, 3.0), (2, 6, 3.0), (2, 3, 1.5), (1, 0, 0.0)])
def test_launches_over_campaigns(monkeypatch, campaigns, launches, want):
    monkeypatch.setattr(spans, "recorded", lambda: _seen(campaigns, launches))
    assert reader().read(FAULTS) == pytest.approx(want)


@pytest.mark.parametrize("seen", [
    None, {"spans": [], "counts": {}}, _seen(1, None),
    {"spans": [], "counts": {"launches.fault_lanes": 3}}],
    ids=["older", "silent", "no-kernel", "no-campaign"])
def test_none_where_the_program_records_nothing(monkeypatch, seen):
    monkeypatch.setattr(spans, "recorded", lambda: seen)
    assert reader().read(FAULTS) is None


def test_none_untraced_or_in_the_other_kind(monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: _seen(1, 3))
    assert reader().read({**FAULTS, "trace": None}) is None
    assert reader().read(SEARCH) is None
