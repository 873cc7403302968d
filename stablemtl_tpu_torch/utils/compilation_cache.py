"""Persistent cache of what the port compiles: the CUDA kernel libraries.

Counterpart of the JAX package's `utils/compilation_cache.py`, which keeps
XLA's compiled programs on disk. The port compiles no graph (nothing calls
`torch.compile`; the serving artifact is a `torch.export` program), but
each process that launches a kernel needs its library, which nvcc builds
from `csrc/` at first use (`ops/cuda_build.py`). Built once into the cache
directory, every later process (the CLIs, the ranks of a process group)
loads the library instead of compiling it again. Each library is named by
a hash of all it is built from (its sources, nvcc's flags and release, the
machine), so one directory serves every host and toolkit that shares it,
and an edited source or another toolkit builds a library of its own.
"""

from __future__ import annotations

import os

DEFAULT_CACHE_ROOT = os.environ.get(
    "STABLEMTL_TORCH_CACHE",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "_build"))


def enable_persistent_cache(cache_dir: str | None = None) -> str:
    """Build and load the kernel libraries in `cache_dir` (default
    DEFAULT_CACHE_ROOT), made if missing; returns it. Calling it again
    with the same directory changes nothing."""
    from pathlib import Path

    from ..ops import cuda_build

    cache_dir = cache_dir or DEFAULT_CACHE_ROOT
    os.makedirs(cache_dir, exist_ok=True)
    cuda_build.BUILD_DIR = Path(cache_dir)
    return cache_dir
