"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Each source under ``src/repro_torch/csrc/`` is compiled on first use, for
``sm_90a``, into a shared library with a plain C interface under
``build/repro_torch_kernels/`` at the repository root (git-ignored). The
library name carries a digest of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded. `build` starts one
nvcc per missing library, all at once. Every exported C function returns
the `cudaGetLastError()` of its launch; `check_launch` raises on non-zero.

Nothing is built or loaded at import time: this module is imported on
machines without nvcc or a GPU, where only the plain versions run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("fitness", "domination", "tree_infer", "qmatmul", "flash_attn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[str, ctypes._CFuncPtr] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((home and os.path.join(home, "bin", "nvcc")),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the CUDA kernels build only where the CUDA toolkit is "
        "installed")


def library_path(name: str) -> Path:
    """Where the library of source ``name`` lives, keyed by its digest."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> float:
    """Compile every library of ``names`` that is not built yet, one nvcc
    process per source, all started together. Returns the seconds spent.
    The compiler's report (registers, shared memory, spills) is kept beside
    each library as ``.log``."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise KernelBuildError("\n".join(errors))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's report for the built library of ``name`` ('' if none)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def function(name: str, fn: str, n_ptrs: int, n_ints: int, n_floats: int = 0):
    """The C entry point ``fn`` of library ``name`` with its arguments
    declared: ``n_ptrs`` pointers, ``n_ints`` ints, ``n_floats`` floats and
    the stream, pointers and stream as ``c_void_p`` so that ctypes never cuts
    them to 32 bits; it returns the launch's CUDA error. The library is built and loaded, and
    the function bound, on the first call only."""
    func = _FUNCS.get(fn)
    if func is not None:
        return func
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    func = getattr(lib, fn)
    func.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                     + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    func.restype = ctypes.c_int
    _FUNCS[fn] = func
    return func


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_launch(rc: int, kernel: str) -> None:
    if rc != 0:
        raise KernelLaunchError(
            f"{kernel} launch failed with CUDA error {rc}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            device: torch.device, shape: tuple | None = None) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    (and of ``shape`` where given)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


def on_cuda(t: torch.Tensor, kernel: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{kernel}: unsupported device {t.device}")
