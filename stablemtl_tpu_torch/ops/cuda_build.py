"""Build the CUDA sources under `csrc/` at first use and load them.

Each source (one per kernel; shared code in `csrc/*.cuh`) compiles with
nvcc into a shared library with a plain C interface (no PyTorch headers, so
a build takes seconds), which the op modules load with ctypes: objects
linked into the library, the forward kernels' sources in parts (`PARTS`),
one nvcc for each variant's instances beside the source's own. Libraries
go to `BUILD_DIR` (`utils/compilation_cache.py`: STABLEMTL_TORCH_CACHE,
else the package's `_build/`), named by a hash of the sources, the flags,
nvcc's release and the machine, so an edited source or another toolkit
rebuilds and a stale library is never loaded. `build()` starts every nvcc
at once; `launch()` calls an entry point on tensors' pointers and the
current stream, under their device. Nothing is built or loaded at import
time.

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
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..utils.compilation_cache import DEFAULT_CACHE_ROOT

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
# where libraries are built and loaded from (`enable_persistent_cache`
# moves it)
BUILD_DIR = Path(DEFAULT_CACHE_ROOT)
SOURCES = {name: f"{name}.cu" for name in (
    "flash_fwd_a", "flash_fwd_b", "flash_fwd_lse", "flash_bwd_dq",
    "flash_bwd_dkv", "geglu")}
# (pointers, ints, floats) of each entry point smtl_<name>, before the stream
SIGNATURES = {"flash_fwd_a": (4, 7, 1), "flash_fwd_b": (4, 6, 1),
              "flash_fwd_lse": (5, 7, 1), "flash_bwd_dq": (7, 4, 2),
              "flash_bwd_dkv": (8, 4, 2), "geglu": (4, 5, 0)}


def _variant_parts(lsum: bool) -> list:
    """The defines of each variant's part of a forward kernel's source:
    SMTL_POLY (STABLEMTL_FLASH_POLY_EXP's degree) and SMTL_LSUM
    (STABLEMTL_FLASH_MXU_LSUM, resident kernels only)."""
    return [(f"-DSMTL_POLY={poly}", f"-DSMTL_LSUM={int(on)}")
            for poly in (0, 3, 4) for on in ((False, True) if lsum else
                                             (False,))
            if poly or on]


# Compiled whole, with every variant's instances, the resident forward
# sources took up to 121 s of nvcc on the H100 machine (PERF.md): each
# variant's instances compile in a part of their own instead, in parallel.
PARTS = {"flash_fwd_a": _variant_parts(True),
         "flash_fwd_lse": _variant_parts(True),
         "flash_fwd_b": _variant_parts(False)}
# the dtype argument of every entry point
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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


@functools.lru_cache(maxsize=None)
def nvcc_release() -> str:
    """The release line of `nvcc --version` (the toolkit that builds the
    libraries), or "" where there is no nvcc."""
    try:
        out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return ""
    lines = [line for line in out.splitlines() if "release" in line]
    return lines[-1].strip() if lines else out.strip()


def lib_path(name: str) -> Path:
    """The library of source `name` in BUILD_DIR, keyed by the source,
    every shared header in csrc/, the flags, the parts' defines, nvcc's
    release and the machine."""
    digest = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest.update(repr(PARTS.get(name)).encode())
    digest.update(f"{nvcc_release()}|{platform.machine()}".encode())
    digest = digest.hexdigest()
    return Path(BUILD_DIR) / f"lib{name}-{digest[:12]}.so"


def start_build(name: str, csrc: Path, out: Path):
    """Start nvcc on source `name` under `csrc` for library `out`: one
    process for the source and one for each of its PARTS, all at once.
    Returns a function that waits for them, links their objects, moves the
    library into place (a concurrent loader never sees half of it) and
    returns (seconds, ptxas log); it raises with nvcc's output on a
    failure."""
    src = Path(csrc) / SOURCES[name]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    units = []
    for i, defs in enumerate([()] + PARTS.get(name, [])):
        obj = out.with_suffix(f".{os.getpid()}.{i}.o")
        units.append((subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", *defs, "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            defs, obj))

    def finish():
        logs = []
        try:
            for proc, defs, _ in units:
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {SOURCES[name]} "
                                       f"{' '.join(defs)}:\n{log}")
                logs.append(log)
            link = subprocess.run(
                [_nvcc(), "-shared", "-o", str(tmp),
                 *(str(obj) for *_, obj in units)],
                capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"linking {SOURCES[name]} failed:\n"
                                   f"{link.stdout}{link.stderr}")
        finally:
            for *_, obj in units:
                obj.unlink(missing_ok=True)
        os.replace(tmp, out)
        return time.perf_counter() - t0, "\n".join(logs)

    return finish


def build(names=None) -> dict:
    """Compile the named sources (default: all) that are not built yet,
    every nvcc process (`start_build`) in parallel. Returns {name:
    (seconds, ptxas log)} for the ones compiled here; raises with nvcc's
    output on a failure."""
    with _BUILD_LOCK:
        names = list(SOURCES) if names is None else list(names)
        Path(BUILD_DIR).mkdir(parents=True, exist_ok=True)
        started = {name: start_build(name, CSRC, lib_path(name))
                   for name in names if not lib_path(name).exists()}
        return {name: finish() for name, finish in started.items()}


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
