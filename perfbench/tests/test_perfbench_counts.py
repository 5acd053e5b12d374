"""The metrics' operation and byte counts against values worked by hand at
the har shapes (P=512, B=3090, N=178, F=561, 107 distinct features read,
H=16, C=6), and the readers on a hand-made record."""
from __future__ import annotations

import pytest

from perfbench import harness, peaks
from perfbench.tests.layout import REPO


def reader(name):
    return harness.load_module(REPO / "perfbench/metrics" / f"{name}.py")


def family(name):
    return harness.load_module(REPO / "perfbench/families" / f"{name}.py")


def test_tree_fitness_counts_at_har():
    ops, n_bytes = reader("fitness_roofline").needed(512, 3090, 178, 107, 14.0)
    assert ops == 512 * 3090 * 15 == 23_731_200
    # 3090 rows x 107 codes + 512 x 535 float32 genes + 512 int32 counts
    assert n_bytes == 330_630 + 1_095_680 + 2_048 == 1_428_358
    bound = peaks.roofline_s(ops, peaks.FP32_OPS_PER_S, n_bytes)
    assert bound == pytest.approx(1_428_358 / 3.35e12)        # bytes bound
    assert 100 * bound / 0.6e-3 == pytest.approx(0.071062, rel=1e-4)


def test_qmatmul_counts_at_har():
    ops, n_bytes = reader("qmatmul_roofline").needed(3090, 561, 512 * 16)
    assert ops == 2 * 3090 * 561 * 8192 == 28_401_500_160
    assert n_bytes == 1_733_490 + 4_595_712 + 101_253_120 == 107_582_322
    bound = peaks.roofline_s(ops, peaks.INT8_OPS_PER_S, n_bytes)
    assert bound == pytest.approx(107_582_322 / 3.35e12)       # bytes bound
    assert 100 * bound / 0.1024e-3 == pytest.approx(31.3615, rel=1e-4)


@pytest.mark.parametrize("name,ops,peak", [
    ("tree", 512 * 3090 * 15, 67e12),
    ("mlp", 2 * 512 * 3090 * (561 * 16 + 16 * 6), 1979e12),
])
def test_gen_mfu_counts_at_har(name, ops, peak):
    shape = {"pop": 512, "rows": 3090, "features": 561, "hidden": 16,
             "classes": 6, "mean_depth": 14.0}
    assert family(name).generation_needs(shape) == (ops, peak)
    shape.update(gen_ops=ops, gen_peak=peak)
    record = {"kind": "search", "shape": shape, "traced_generations": 80,
              "trace": {"window_s": 0.24, "busy_s": 0.2, "kernels": {}}}
    name = "gen_mfu" if name == "tree" else "gen_mfu.mlp"
    # 3 ms a generation
    assert reader(name).read(record) == pytest.approx(
        100 * ops / (3e-3 * peak))


def test_kernel_readers_on_a_record():
    shape = {"family": "tree", "pop": 512, "rows": 3090, "comparators": 178,
             "features_used": 107, "mean_depth": 14.0}
    trace = {"window_s": 0.3, "busy_s": 0.27, "kernels": {
        "fitness_mma_kernel": [2 * 0.6e-3, 2],
        "anon::peel_kernel": [0.002, 80],
        "domination_bits_kernel": [0.001, 80]}}
    record = {"kind": "search", "shape": shape, "trace": trace,
              "traced_generations": 80, "chunk_host_ms": 2.5}
    assert reader("fitness_roofline").read(record) == pytest.approx(
        0.071062, rel=1e-4)
    assert reader("qmatmul_roofline").read(record) is None
    assert reader("sort_ms_per_gen").read(record) == pytest.approx(3 / 80)
    assert reader("idle_share.search").read(record) == pytest.approx(0.1)
    assert reader("idle_share.faults").read(record) is None
    # a family's own metric reads any search record: BENCHMARK.json's
    # ``workloads`` keeps it to its cells
    assert reader("idle_share.mlp").read(record) == pytest.approx(0.1)
    assert reader("chunk_host_ms").read(record) == 2.5
    assert reader("chunk_host_ms.mlp").read(record) == 2.5


def test_fault_readers_on_a_record():
    record = {"kind": "faults", "lanes": 33_602, "window_s": 4.0,
              "traced_lanes": 16_801,
              "trace": {"window_s": 2.0, "busy_s": 1.5, "kernels": {}}}
    assert reader("fault_lanes_per_s").read(record) == 33_602 / 4.0
    assert reader("fault_device_ms_per_klane").read(record) == pytest.approx(
        1500 / 16.801)
    assert reader("idle_share.faults").read(record) == pytest.approx(0.25)
    assert reader("evals_per_s").read(record) is None
    assert reader("evals_per_s.mlp").read(record) is None
