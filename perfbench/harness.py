"""Runs one cell once and assembles its result line, driven by data.

Everything is found by name. `BENCHMARK.json` at the checkout's root
names each cell's configuration and traffic mix and lists the metrics;
the configuration is the JSON file its entry names, whose ``family``
names the module ``perfbench/families/<family>.py`` that makes its inputs
and builds its problem and its plain reference; the mix is
``perfbench/traffic/<traffic>.json``, whose ``kind`` names the module
``perfbench/kinds/<kind>.py`` that runs it; each metric is read by
``perfbench/metrics/<metric>.py``. A cell, a configuration, a family, a
mix, a kind or a metric is added by adding its files and its entry,
editing none.

A kind's ``measure(ctx)`` makes the set-up, the measured window and,
with ``ctx.trace``, the traced stretch, and returns the run's record and
a ``judge()``. The harness reads the peak memory, lets the program's
state go, and only then calls ``judge()``, which runs the plain reference
and returns the compared numbers, each with its limit. A metric's
``read(record)`` returns its value, or None where the record holds
nothing for it.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Context:
    config: dict
    family: object
    traffic: dict
    inputs: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def entry(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path: Path):
    """The module in file ``path``, loaded under a name of its own."""
    tag = hashlib.sha256(str(path.resolve()).encode()).hexdigest()[:8]
    name = f"perfbench_{path.parent.name}_{path.stem}_{tag}".replace(
        ".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def cell_chips(cell: str, root: Path = ROOT) -> int:
    return int(entry(benchmark(root)["workloads"], cell, "cell")["chips"])


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT,
             t_start: float | None = None) -> dict:
    """The result line of one run of ``cell``, as a dict."""
    import torch

    from perfbench import inputs

    t_start = time.time() if t_start is None else t_start
    bench = benchmark(root)
    spec = entry(bench["workloads"], cell, "cell")
    config_entry = entry(bench["configs"], spec["config"], "configuration")
    config_file = root / config_entry["file"]
    traffic = json.loads(
        (root / "perfbench" / "traffic" / f"{spec['traffic']}.json").read_text())
    kind = load_module(root / "perfbench" / "kinds" / f"{traffic['kind']}.py")
    config = json.loads(config_file.read_text())
    family = load_module(inputs.family_file(config, root))
    ctx = Context(config=config, family=family, traffic=traffic,
                  inputs=inputs.load(config_file, family, root),
                  seed=int(seed), seconds=float(seconds), trace=bool(trace),
                  device=torch.device(device), t_start=t_start)
    record, judge = kind.measure(ctx)
    on_card = ctx.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(ctx.device) if on_card else 0
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = judge()
    correct = all(_within(value, limit) for _, value, limit in checks)

    metrics = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        reader = load_module(root / "perfbench" / "metrics" / f"{m['name']}.py")
        value = reader.read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(ctx.device) if on_card else "cpu",
           "count": int(spec["chips"]),
           "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(record["attempted"]),
              "failed": int(record["failed"]), "metrics": metrics,
              "device": dev}
    traced = record.get("trace")
    if trace and traced:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["check"] = {name: {"value": float(value), "limit": float(limit)}
                       for name, value, limit in checks}
    return result


def _within(value, limit) -> bool:
    return not math.isnan(value) and value <= limit
