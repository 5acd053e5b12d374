"""The check of `correct` fails what it has to fail, and nothing the
benchmark runs loads JAX or the JAX package.

Each small cell is run with its timed path swapped underneath
(`perfbench.control`): the plain reference a notch below the stated
precision, a chunk that returns its state unchanged, half of the rows
left out, one answer altered, the circuit lowered wrong, half the fault
sites left out. Every run skips the look for a card and
drives the rest of the harness."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from perfbench import control
from perfbench.tests import layout

SEARCH = ("tree-seeds.search-tiny", "mlp-seeds.search-tiny")
CASES = ([(cell, swap) for cell in SEARCH
          for swap in ("control", "unchanged", "half", "altered")]
         + [("tree-seeds.faults", swap)
            for swap in ("control", "half", "altered", "circuit", "sites")])
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return layout.make(tmp_path_factory.mktemp("perfbench"))


@pytest.mark.parametrize("cell,swap", CASES)
def test_swapped_path_is_not_correct(root, cell, swap):
    (line,) = control.run(cell, [2 ** 33 + 5], 0.2, swap, device="cpu",
                          root=root)
    assert not line["correct"], line
    assert any(v > 0 for v in line["check"].values())


def test_swaps_are_undone(root):
    (line,) = control.run("tree-seeds.search-tiny", [9], 0.1, "unchanged",
                          device="cpu", root=root)
    assert not line["correct"]
    from perfbench import harness

    result = harness.run_cell("tree-seeds.search-tiny", 9, 0.1, False,
                              device="cpu", root=root)
    assert result["correct"]


def _top_level_imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(
    (layout.REPO / "perfbench").rglob("*.py")), ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    """No file of the benchmark imports JAX or the JAX package; the plain
    reference imports no part of the program either."""
    names = _top_level_imports(path)
    assert not names & FORBIDDEN
    if "reference" in path.parts:
        assert "repro_torch" not in names


def test_a_run_loads_no_jax(root):
    """A whole small run in a fresh process, then the top-level names of
    every loaded module, compared whole."""
    script = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(layout.REPO)!r}, {str(layout.REPO / 'src')!r}]\n"
        "from perfbench import harness, run\n"
        "for cell in ('tree-seeds.search-tiny', 'mlp-seeds.search-tiny',"
        " 'tree-seeds.faults'):\n"
        f"    r = harness.run_cell(cell, 1, 0.1, False, device='cpu', "
        f"root=__import__('pathlib').Path({str(root)!r}))\n"
        "    assert r['correct']\n"
        "print(json.dumps(run.forbidden_modules()))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    found, loaded = (json.loads(x) for x in out.stdout.splitlines()[-2:])
    assert found == [] and "repro_torch" in loaded
    assert not set(loaded) & FORBIDDEN
