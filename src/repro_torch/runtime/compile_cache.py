"""A persistent build directory for the kernels: the port's compile cache.

The counterpart of `repro.runtime.compile_cache`. The JAX package points
XLA's persistent compilation cache at a directory; the port compiles its
kernels with nvcc (`kernels._build`), into libraries named by a digest of
their sources and flags. Pointing the build directory at a persistent
directory makes a second run of the same campaign load the libraries it
built and run no nvcc:

    from repro_torch.runtime import compile_cache
    compile_cache.enable("~/.cache/repro-torch-kernels")

The ``--compilation-cache DIR`` flag of the search, sweep and serve CLIs
calls it before the first build. It also sets ``$REPRO_TORCH_BUILD_DIR``,
so the ranks a mesh run starts later build into (and load from) the same
directory.
"""
from __future__ import annotations

import os
from pathlib import Path

from repro_torch.kernels import _build


def enable(cache_dir: str) -> bool:
    """Build and load the kernels' libraries under ``cache_dir`` (created
    if needed) from now on, in this process and the ones it starts.
    Returns True: the cache is active."""
    path = os.path.abspath(os.path.expanduser(cache_dir))
    os.makedirs(path, exist_ok=True)
    _build.BUILD_DIR = Path(path)
    os.environ[_build.BUILD_DIR_ENV] = path
    return True
