"""NSGA-II pairwise domination: Hopper kernel and plain version.

Replaces the TPU kernel `repro/kernels/domination.py::domination_block`
(and `domination_matrix`, its square case): for minimised objectives,
``dom[i, j] = all(a_i <= b_j) & any(a_i < b_j)``. The kernel
(`csrc/domination.cu`; its bound and design are stated there) masks ragged
edges itself, so no +inf padding is needed, and writes the matrix as a
bool tensor. On a CPU tensor the wrapper runs the plain PyTorch version; on
a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def domination_block_plain(objs_i: torch.Tensor,
                           objs_j: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `domination_block`."""
    a = objs_i[:, None, :]
    b = objs_j[None, :, :]
    return (a <= b).all(-1) & (a < b).any(-1)


def domination_block(objs_i: torch.Tensor,
                     objs_j: torch.Tensor) -> torch.Tensor:
    """(Pi, Pj) bool: row i dominates column j. objs_i (Pi, M) and objs_j
    (Pj, M) float32. Counts its kernel launches in
    ``domination_block.launches``."""
    if not _build.on_cuda(objs_i, "domination_block"):
        return domination_block_plain(objs_i, objs_j)
    dev = objs_i.device
    pi, m = objs_i.shape
    pj = objs_j.shape[0]
    _build.require(objs_i, "objs_i", torch.float32, dev)
    _build.require(objs_j, "objs_j", torch.float32, dev, (pj, m))
    dom = torch.empty((pi, pj), dtype=torch.bool, device=dev)
    if pi == 0 or pj == 0 or m == 0:
        return dom.fill_(False) if m == 0 else dom
    fn = _build.function("domination", "repro_domination_block", 3, 3)
    rc = fn(_build.ptr(objs_i), _build.ptr(objs_j), _build.ptr(dom), pi, pj, m,
            _build.stream(dev))
    _build.check_launch(rc, "domination_block")
    domination_block.launches += 1
    return dom


domination_block.launches = 0


def domination_matrix(objs: torch.Tensor) -> torch.Tensor:
    """(P, P) bool: the square case, one operand against itself."""
    return domination_block(objs, objs)
