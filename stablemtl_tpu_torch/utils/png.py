"""PNG in the standard library (zlib, struct) and numpy: the serving path
writes its visualizations and reads its inputs without PIL or OpenCV.

`write_png` writes 8-bit grayscale, RGB or RGBA, unfiltered rows.
`read_png` reads 8-bit RGB or RGBA without interlacing, with any of the
five row filters, and raises `UnsupportedPNG` for other variants (palette,
grayscale, 16-bit, interlaced), which callers hand to an image library.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG color type
_CHANNELS = {2: 3, 6: 4}           # readable color type -> channels


class UnsupportedPNG(ValueError):
    """A PNG variant `read_png` does not decode."""


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W], [H, W, 1], [H, W, 3] or [H, W, 4] -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG images are uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in _COLOR_TYPES:
        raise ValueError(f"expected [H, W] or [H, W, 1|3|4], got "
                         f"{img.shape}")
    h, w, c = img.shape
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    rows = np.concatenate([np.zeros((h, 1), np.uint8),  # filter 0 per row
                           img.reshape(h, w * c)], axis=1)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of the decompressed scanlines."""
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected "
                         f"{h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum along each channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) % 256
        elif kind == 2:  # Up
            cur = (line + prev) % 256
        elif kind in (3, 4):  # Average, Paeth: left to right, pixel by pixel
            cur = np.zeros(stride, np.int32)
            left = np.zeros(bpp, np.int32)
            up_left = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                up = prev[x:x + bpp]
                pred = ((left + up) // 2 if kind == 3
                        else _paeth(left, up, up_left))
                left = (line[x:x + bpp] + pred) % 256
                cur[x:x + bpp] = left
                up_left = up
        else:
            raise ValueError(f"bad PNG row filter {kind}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3] RGB (an alpha channel is dropped)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(
                ">I", data[pos + 8 + length:pos + 12 + length])[0]:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise UnsupportedPNG(f"PNG bit depth {depth}, color type {color}, "
                             f"interlace {interlace}: only 8-bit RGB/RGBA "
                             f"without interlacing is read here")
    c = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw, h, w * c, c).reshape(h, w, c)
    return np.ascontiguousarray(img[..., :3])


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
