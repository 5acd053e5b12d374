"""The port's search mesh (`repro_torch.launch.mesh`), its transport choice
and its compile cache (`repro_torch.runtime.compile_cache`), on the CPU.

`make_search_mesh` is held to `repro.launch.mesh.make_search_mesh` on the
spec strings of tests/test_launch_mesh.py: the same shapes and axis names
for the specs one device (one rank) can take, the same errors for the
others. The multi-rank paths are in tests/test_torch_dist.py.
"""
from __future__ import annotations

import os
import pathlib
import stat
import subprocess
import sys

import jax
import pytest
import torch
import torch.distributed as dist

from repro.launch.mesh import make_search_mesh as j_make_search_mesh
from repro_torch.kernels import _build
from repro_torch.launch import mesh as t_mesh
from repro_torch.runtime import compile_cache

REPO = pathlib.Path(__file__).resolve().parents[1]

SPECS = [None, "", "none", "auto", "1", "1x1", "junk", "0", "1x1x1", "2",
         "2x1"]
AXES = [("pop",), ("bucket", "pop"), ("data",)]


@pytest.fixture
def single_group():
    """Leave no process group behind (a one-rank mesh makes one)."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()
        t_mesh._SINGLE.clear()


def _outcome(make, spec, axes):
    """("mesh", shape, names), ("none",) or ("error", message)."""
    try:
        mesh = make(spec, axes)
    except ValueError as e:
        return ("error", str(e))
    if mesh is None:
        return ("none",)
    if hasattr(mesh, "mesh_dim_names"):   # a torch DeviceMesh
        return ("mesh", tuple(mesh.shape), tuple(mesh.mesh_dim_names))
    return ("mesh", tuple(mesh.shape.values()), tuple(mesh.axis_names))


@pytest.mark.parametrize("axes", AXES)
@pytest.mark.parametrize("spec", SPECS)
def test_make_search_mesh_matches_jax(spec, axes, single_group):
    assert len(jax.devices()) == 1   # one CPU device: one rank here
    want = _outcome(j_make_search_mesh, spec, axes)
    got = _outcome(lambda s, a: t_mesh.make_search_mesh(s, a, device="cpu"),
                   spec, axes)
    assert got[0] == want[0], (got, want)
    if want[0] == "error" and "needs" in want[1]:
        # JAX counts host devices; the port counts the group's ranks
        assert want[1].split(", ")[0] in got[1]
        assert "the process group has 1 rank" in got[1]
    else:
        assert got == want


def test_mesh_shape_and_size():
    assert t_mesh.mesh_shape("2x4", ("bucket", "pop"), "cpu") == (2, 4)
    assert t_mesh.mesh_shape("4", ("bucket", "pop"), "cpu") == (1, 4)
    assert t_mesh.mesh_size("auto", ("data",), "cpu") == 1
    assert t_mesh.mesh_size(None, ("pop",), "cpu") == 1
    assert t_mesh.mesh_size("2x3", ("bucket", "pop"), "cpu") == 6


@pytest.mark.parametrize("device_type, world, cards, want", [
    ("cpu", 4, 0, "gloo"),        # ranks on the CPU
    ("cuda", 2, 1, "gloo"),       # two ranks share one card
    ("cuda", 4, 2, "gloo"),
    ("cuda", 2, 2, "nccl"),       # a card a rank
    ("cuda", 1, 1, "nccl"),
    ("cuda", 4, 8, "nccl"),
])
def test_collective_backend(device_type, world, cards, want):
    assert t_mesh.collective_backend(device_type, world, cards) == want


def test_rank_device_and_writer(single_group):
    assert t_mesh.rank_device("cpu") == torch.device("cpu")
    assert t_mesh.is_writer()
    t_mesh.barrier()   # no group: nothing to wait for
    t_mesh.make_search_mesh("1", ("pop",), device="cpu")
    assert dist.is_initialized() and t_mesh.is_writer()
    assert t_mesh.run_ranks(lambda x: x + 1, 1, "cpu", (1,)) == 2


def test_run_ranks_refuses_a_group_of_another_size(monkeypatch, single_group):
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        t_mesh.run_ranks(print, 2, "cpu")


def _fake_nvcc(tmp_path) -> pathlib.Path:
    """A CUDA_HOME whose bin/nvcc writes its -o file and logs each call."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo call >> {tmp_path / 'calls'}\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then shift; echo lib > \"$1\"; fi\n"
        "  shift\n"
        "done\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return home


def test_compile_cache_redirects_the_build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.delenv(_build.BUILD_DIR_ENV, raising=False)
    cache = tmp_path / "cache"
    assert compile_cache.enable(str(cache)) is True
    assert os.environ[_build.BUILD_DIR_ENV] == str(cache)
    assert _build.BUILD_DIR == cache and cache.is_dir()
    assert _build.library_path("domination").parent == cache
    # a process started later (a mesh's rank) builds into the same place
    out = subprocess.run(
        [sys.executable, "-c", "from repro_torch.kernels import _build; "
         "print(_build.BUILD_DIR)"], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")}, check=True)
    assert out.stdout.strip() == str(cache)
    # the second build of the same sources loads what the first built
    monkeypatch.setenv("CUDA_HOME", str(_fake_nvcc(tmp_path)))
    assert _build.build(("domination", "fitness")) > 0
    assert _build.build(("domination", "fitness")) == 0.0
    assert (tmp_path / "calls").read_text().count("call") == 2
    assert _build.library_path("fitness").exists()
