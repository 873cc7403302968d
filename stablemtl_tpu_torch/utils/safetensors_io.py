"""Read and write `.safetensors` files without the `safetensors` package.

The format: an 8-byte little-endian header length N, N bytes of JSON
({name: {"dtype", "shape", "data_offsets": [begin, end]}} with offsets into
the data buffer, and an optional "__metadata__" of string pairs), then the
data buffer: each tensor's bytes, row-major, little-endian. Dtypes F32,
F16, BF16, I64, I32 and 0-element tensors are supported.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64, "I32": torch.int32}
_CODES = {v: k for k, v in DTYPES.items()}
# a header larger than this is not a safetensors file (the package's limit)
MAX_HEADER_BYTES = 100_000_000


def read_header(path: str):
    """(header dict without "__metadata__", metadata dict, data offset in
    the file)."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (too short)")
        (n,) = struct.unpack("<Q", raw)
        if n > MAX_HEADER_BYTES:
            raise ValueError(f"{path}: header of {n} bytes")
        header = json.loads(f.read(n))
    metadata = header.pop("__metadata__", None) or {}
    return header, metadata, 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of a .safetensors file, in the header's order. The
    data is memory-mapped copy-on-write: each tensor's pages are read when
    it is first touched, and writing to a tensor leaves the file as it
    is."""
    header, _, start = read_header(path)
    size = max((int(info["data_offsets"][1]) for info in header.values()),
               default=0)
    buf = (torch.from_numpy(np.memmap(path, dtype=np.uint8, mode="c",
                                      offset=start, shape=(size,)))
           if size else torch.empty(0, dtype=torch.uint8))
    out = {}
    for name, info in header.items():
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             f"not one of {sorted(DTYPES)}")
        dtype = DTYPES[info["dtype"]]
        shape = [int(s) for s in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        item = torch.tensor([], dtype=dtype).element_size()
        if end - begin != item * int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: {name} spans {end - begin} bytes for "
                             f"shape {shape} of {info['dtype']}")
        if begin == end:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        data = buf[begin:end]
        if begin % item:  # a view of another dtype must be aligned to it
            data = data.clone()
        out[name] = data.view(dtype).reshape(shape)
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write `tensors` (CPU or card) to `path`, largest element size first,
    then by name (the package's order: each tensor is aligned to its
    element size behind a header padded with spaces to a multiple of 8).
    Returns the bytes written."""
    header, offset = {}, 0
    names = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    for name in names:
        t = tensors[name]
        if t.dtype not in _CODES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             f"code here ({sorted(DTYPES)})")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for name in names:
            t = tensors[name]
            if t.numel():
                raw = t.detach().contiguous().cpu().reshape(-1).view(
                    torch.uint8)
                f.write(memoryview(raw.numpy()))
    return 8 + len(text) + offset
