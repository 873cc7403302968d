"""Build the CUDA sources under `csrc/` at first use and load them.

Each source (one per kernel; shared code in `csrc/*.cuh`) compiles with
nvcc into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), which the op
modules load with ctypes. Libraries go to `_build/` inside the package,
named by a hash of the source and flags, so an edited source rebuilds and a
stale library is never loaded. `build()` starts one nvcc per source, all at
once. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = {name: f"{name}.cu" for name in (
    "flash_fwd_a", "flash_fwd_b", "flash_fwd_lse", "flash_bwd_dq",
    "flash_bwd_dkv")}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "stablemtl_tpu_torch need the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    """The library of source `name`, keyed by the source, every shared
    header in csrc/ and the flags."""
    digest = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest = digest.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=None) -> dict:
    """Compile the named sources (default: all) that are not built yet, one
    nvcc process each, in parallel. Returns {name: (seconds, ptxas log)}
    for the ones compiled here; raises with nvcc's output on a failure."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    report = {}
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCES[name]}:\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
        report[name] = (time.perf_counter() - t0, log)
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source `name`, building it if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(lib_path(name)))
    return _loaded[name]
