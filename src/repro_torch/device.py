"""Device selection for the port's entry points.

Entry points (`build_problem`, `run_search`, `ClassifyServer`, the CLI) take
an explicit ``device`` that defaults to ``"cuda"``. On a machine without a
GPU they raise `CudaUnavailableError` unless the caller asked for the CPU;
nothing falls back to the CPU silently.
"""
from __future__ import annotations

import torch


class CudaUnavailableError(RuntimeError):
    """A CUDA device was requested (or defaulted to) but none is present."""


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The `torch.device` for ``device``; raises if it is CUDA and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CudaUnavailableError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the CPU")
    return dev
