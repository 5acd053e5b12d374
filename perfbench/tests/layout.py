"""A small copy of the benchmark's layout for the CPU tests: the har
configurations re-pointed at the seeds dataset, a search mix of pop 8 in
chunks of 2 generations, and a small cell for each real one, listed in
every metric's cells where the real one is."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELLS = {"tree-seeds.search-tiny": ("tree-seeds", "search-tiny"),
         "mlp-seeds.search-tiny": ("mlp-seeds", "search-tiny"),
         "tree-seeds.faults": ("tree-seeds", "faults")}
STANDS_FOR = {"tree-seeds.search-tiny": "tree-har.search-p512",
              "mlp-seeds.search-tiny": "mlp-har.search-p512",
              "tree-seeds.faults": "tree-har.faults"}


def write_json(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def make(dest: Path) -> Path:
    """The layout under ``dest``; returns its root."""
    root = dest / "checkout"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for fam in ("tree", "mlp"):
        cfg = json.loads((REPO / f"perfbench/configs/{fam}-har.json").read_text())
        cfg.update(name=f"{fam}-seeds", dataset="seeds")
        if fam == "mlp":
            cfg.update(n_hidden=4, train={**cfg["train"], "steps": 30})
        write_json(root / f"perfbench/configs/{fam}-seeds.json", cfg)
        bench["configs"].append({
            "name": f"{fam}-seeds", "source": "https://arxiv.org/abs/2203.08011",
            "file": f"perfbench/configs/{fam}-seeds.json", "reduced": [],
            "why": "a small stand-in for the CPU tests"})
    mix = json.loads((REPO / "perfbench/traffic/search-p512.json").read_text())
    mix.update(pop_size=8, chunk_generations=2)
    write_json(root / "perfbench/traffic/search-tiny.json", mix)
    for name, (config, traffic) in CELLS.items():
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "a small stand-in for the CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [n for n, real in STANDS_FOR.items()
                               if real in m["workloads"]]
    write_json(root / "BENCHMARK.json", bench)
    return root
