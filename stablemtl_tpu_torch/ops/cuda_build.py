"""Build the CUDA sources under `csrc/` at first use and load them.

Each source (one per kernel; shared code in `csrc/*.cuh`) compiles with
nvcc into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), which the op
modules load with ctypes. Libraries go to `_build/` inside the package,
named by a hash of the source and flags, so an edited source rebuilds and a
stale library is never loaded. `build()` starts one nvcc per source, all at
once; `launch()` calls an entry point on tensors' pointers and the current
stream, under their device. Nothing is built or loaded at import time.

`define_op()` registers a kernel as a `torch.library` custom op
`stablemtl::<name>`: the kernel for CUDA tensors, its plain version for CPU
tensors, and a shape-only implementation for tracing, so `torch.export`
records the op as one node and a loaded program launches the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = {name: f"{name}.cu" for name in (
    "flash_fwd_a", "flash_fwd_b", "flash_fwd_lse", "flash_bwd_dq",
    "flash_bwd_dkv", "geglu")}
# (pointers, ints, floats) of each entry point smtl_<name>, before the stream
SIGNATURES = {"flash_fwd_a": (4, 5, 1), "flash_fwd_b": (4, 5, 1),
              "flash_fwd_lse": (5, 5, 1), "flash_bwd_dq": (7, 4, 2),
              "flash_bwd_dkv": (8, 4, 2), "geglu": (4, 5, 0)}
# the dtype argument of every entry point
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the namespace of the custom ops (`torch.ops.stablemtl.<name>`), and the
# library that holds their registrations for the life of the process
OP_NAMESPACE = "stablemtl"
_LIBRARY = torch.library.Library(OP_NAMESPACE, "DEF")

_loaded: dict[str, ctypes.CDLL] = {}
# held across building and loading: replicas in several threads make their
# first launches at once, and must neither build one library twice nor
# load one half written
_BUILD_LOCK = threading.RLock()
_COUNT_LOCK = threading.Lock()


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
    with _BUILD_LOCK:
        return _build(names)


def _build(names) -> dict:
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
    with _BUILD_LOCK:
        if name not in _loaded:
            build([name])
            _loaded[name] = ctypes.CDLL(str(lib_path(name)))
        return _loaded[name]


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """(entry point, error-string function) of library `name`, whose entry
    point is `smtl_<name>`. Under the lock: the cache lets two threads make
    the same first call together."""
    with _BUILD_LOCK:
        lib = load(name)
        fn = getattr(lib, f"smtl_{name}")
        n_ptr, n_int, n_float = SIGNATURES[name]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * n_float + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.smtl_cuda_error_string.argtypes = [ctypes.c_int]
        lib.smtl_cuda_error_string.restype = ctypes.c_char_p
        return fn, lib.smtl_cuda_error_string


def launch(name: str, tensors, *scalars):
    """Call entry point smtl_<name> on the tensors' pointers, the scalars
    and the current stream of their device, with that device current (the
    entry point launches on the calling thread's current device); raise
    with CUDA's message if it fails. Tensors on more than one device raise
    first: a kernel would read another card's pointer as garbage."""
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError(f"{name}: tensors on several devices "
                         f"{sorted({str(t.device) for t in tensors})}")
    fn, error_string = _entry(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), *scalars, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{error_string(err).decode()}")


def count_launch(wrapper) -> None:
    """Add one to `wrapper.launches`; replicas in several threads launch
    at once, and a bare `+= 1` can lose a count between them."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def define_op(name: str, schema: str, plain, kernel, fake):
    """Register op `stablemtl::<name>` with `schema` ("(args) -> results";
    it mutates nothing, each implementation allocates its outputs):
    `plain` for CPU tensors, `kernel` for CUDA tensors (it launches or
    raises, and counts its launch), `fake` the outputs' shapes and dtypes
    alone. No autograd kernel: the callers differentiate in their own
    autograd Functions. Returns the op (an OpOverload).

    `Library.define`/`impl` dispatch straight to the Python
    implementation, without the Python layers `torch.library.custom_op`
    wraps around it, whose host time per call showed in the timings of the
    shortest kernels (PERF.md)."""
    _LIBRARY.define(name + schema)
    _LIBRARY.impl(name, plain, "CPU")
    _LIBRARY.impl(name, kernel, "CUDA")
    torch.library.register_fake(f"{OP_NAMESPACE}::{name}", fake,
                                lib=_LIBRARY)
    return getattr(getattr(torch.ops, OP_NAMESPACE), name).default
