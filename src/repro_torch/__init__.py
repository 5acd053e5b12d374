"""PyTorch/CUDA port of the approximate bespoke decision-tree system.

The package mirrors `repro`'s module names (`repro_torch.core.quant` is the
counterpart of `repro.core.quant`, and so on). It imports torch and numpy
only: never jax and nothing of `repro`. The tests hold every module against
the JAX package on the CPU; the five Hopper kernels under `csrc/` run on
an NVIDIA H100 (`chip_smoke.py` at the repository root drives them).
"""
from repro_torch.device import CudaUnavailableError, resolve_device

__all__ = ["CudaUnavailableError", "resolve_device"]
