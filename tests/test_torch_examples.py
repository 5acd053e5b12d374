"""The port's examples (`examples/torch_*.py`) on the CPU, each in a
subprocess at small flags with ``--device cpu``, exit 0; where a result
is deterministic it is held to the JAX package or to the port's own
entry point:

- the quickstart: the exact accuracy and comparator count of the JAX
  package's seeds tree (`repro.search.build_tree_problem`), and the same
  front as ``python -m repro_torch.search`` with the same flags;
- the distributed GA: the elastic restart of 8 islands' checkpoint onto
  4 ranks gives each rank two islands' rows, 48, as the JAX example's
  ``shard_map`` does;
- LM training: the run resumed after the simulated crash ends at the
  uninterrupted run's loss, exactly (the example's `train_run`, in this
  process);
- LM serving and the quantisation search run through.

Without ``--device`` an example wants CUDA, and here it fails rather
than falling back to the CPU.
"""
from __future__ import annotations

import ast
import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
                + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1")


def _run(*argv, ok: bool = True) -> str:
    proc = subprocess.run([sys.executable, *argv], env=_env(), cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    if ok:
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
        return proc.stdout
    assert proc.returncode != 0
    return proc.stdout + proc.stderr


def _front(out: str) -> list[str]:
    lines = out.splitlines()
    i = lines.index("pareto front (acc_loss, normalized area):")
    return [ln for ln in lines[i + 1:] if ln.startswith("  ")]


def test_quickstart_matches_jax_and_the_cli():
    jx_search = pytest.importorskip("repro.search")
    from repro.core.train import train_tree
    from repro.core.tree import to_parallel
    from repro.datasets import load_dataset

    flags = ["--pop", "16", "--gens", "4", "--device", "cpu"]
    out = _run(str(EXAMPLES / "torch_quickstart.py"), *flags)
    ds = load_dataset("seeds")
    want = jx_search.build_tree_problem(
        to_parallel(train_tree(ds.x_train, ds.y_train, ds.n_classes)),
        ds.x_test, ds.y_test)
    m = re.search(r"comparators=(\d+) leaves=(\d+) test_acc=([\d.]+)", out)
    assert int(m.group(1)) == want.n_comparators
    assert int(m.group(2)) == want.n_leaves
    assert m.group(3) == f"{float(want.exact_accuracy):.6f}"
    assert "netlist verified on" in out
    cli = _run("-m", "repro_torch.search", *flags)
    assert _front(out) == _front(cli) and _front(out)


def test_distributed_ga_restarts_elastically():
    out = _run(str(EXAMPLES / "torch_distributed_ga.py"), "--device", "cpu")
    assert out.count("round ") >= 6
    assert "restored onto 4 ranks: [48, 48, 48, 48] rows a rank" in out
    assert "elastic restart OK" in out


def test_lm_serve_generates():
    out = _run(str(EXAMPLES / "torch_lm_serve.py"), "--tokens", "4",
               "--device", "cpu")
    seqs = ast.literal_eval(out.split("first sequences:")[1].strip())
    assert len(seqs) == 2 and all(len(s) == 4 for s in seqs)


def _quiet(*_) -> None:
    pass


TRAIN_FLAGS = ["--steps", "8", "--d-model", "64", "--layers", "2", "--seq",
               "32", "--batch", "4", "--vocab", "256", "--ckpt-every", "2"]


def test_lm_train_resumes_to_the_uninterrupted_loss(tmp_path):
    out = _run(str(EXAMPLES / "torch_lm_train.py"), *TRAIN_FLAGS,
               "--ckpt-dir", str(tmp_path / "run"), "--device", "cpu")
    assert "resumed at step 4 (checkpoint 3)" in out
    spec = importlib.util.spec_from_file_location(
        "torch_lm_train", EXAMPLES / "torch_lm_train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    args = mod.parser().parse_args(TRAIN_FLAGS)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        resumed = mod.train_run(args, torch.device("cpu"), 4,
                                str(tmp_path / "a"), log=_quiet)
        whole = mod.train_run(args, torch.device("cpu"), None,
                              str(tmp_path / "b"), log=_quiet)
    finally:
        torch.set_num_threads(n)
    assert resumed == whole
    assert f"final loss {resumed:.4f}" in out
    # a directory that holds checkpoints is refused
    _run(str(EXAMPLES / "torch_lm_train.py"), *TRAIN_FLAGS, "--ckpt-dir",
         str(tmp_path / "run"), "--device", "cpu", ok=False)


def test_lm_quant_search_runs():
    out = _run(str(EXAMPLES / "torch_lm_quant_search.py"), "--train-steps",
               "2", "--pop", "4", "--gens", "1", "--device", "cpu")
    assert "pareto (loss increase, cost vs bf16):" in out
    assert re.search(r"dloss=[+-]\d", out)


def test_examples_want_cuda_without_device():
    """No silent CPU: without ``--device`` the example asks for CUDA,
    which this machine lacks."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the example would run on it")
    err = _run(str(EXAMPLES / "torch_lm_serve.py"), "--tokens", "2",
               ok=False)
    assert "CUDA" in err or "cuda" in err
