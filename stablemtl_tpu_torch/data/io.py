"""Host-side raster IO and per-dataset decoders (numpy, channels-last).

Rebuilds the decoding rules scattered through reference src/dataset/*:
- generic image read with tar-archive support (base_mtl_dataset.py:185-196)
- vKITTI depth: uint16 png / 100 -> meters (vkitti_dataset.py:49-53)
- Hypersim depth: uint16 png / 1000 -> meters (hypersim_dataset.py:27)
- vKITTI 16-bit flow png decode (vkitti_dataset.py:96-131)
- vKITTI 16-bit scene-flow png decode, x10 m (vkitti_dataset.py:167-185)
- FlyingThings3D flow png: (v<<16|u) scale 64 offset 32768
  (dataset_preprocess/flying_things_3D/utils.py:248-284)
- KITTI depth: uint16 png / 256 (kitti_dataset.py:55-60)

Copy of `stablemtl_tpu/data/io.py`: the port keeps its
own so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import io as _io
import os
import tarfile
from typing import Optional

import cv2
import numpy as np
from PIL import Image, ImageFile

ImageFile.LOAD_TRUNCATED_IMAGES = True


class RasterSource:
    """Reads rasters from a directory tree or a tar archive
    (base_mtl_dataset.py:100-110,185-196)."""

    def __init__(self, root: str):
        self.root = root
        self.is_tar = os.path.isfile(root) and tarfile.is_tarfile(root)
        self._tar: Optional[tarfile.TarFile] = None

    def _bytes(self, rel_path: str) -> bytes:
        if self.is_tar:
            if self._tar is None:
                self._tar = tarfile.open(self.root)
            return self._tar.extractfile("./" + rel_path).read()
        with open(os.path.join(self.root, rel_path), "rb") as f:
            return f.read()

    def read_image(self, rel_path: str) -> np.ndarray:
        """PIL decode -> numpy (HWC for color, HW for single-channel)."""
        return np.asarray(Image.open(_io.BytesIO(self._bytes(rel_path))))

    def read_image_cv2(self, rel_path: str, flags=cv2.IMREAD_ANYCOLOR
                       | cv2.IMREAD_ANYDEPTH) -> np.ndarray:
        buf = np.frombuffer(self._bytes(rel_path), np.uint8)
        return cv2.imdecode(buf, flags)

    def read_npy(self, rel_path: str) -> np.ndarray:
        return np.load(_io.BytesIO(self._bytes(rel_path)))

    def exists(self, rel_path: str) -> bool:
        if self.is_tar:
            if self._tar is None:
                self._tar = tarfile.open(self.root)
            try:
                self._tar.getmember("./" + rel_path)
                return True
            except KeyError:
                return False
        return os.path.exists(os.path.join(self.root, rel_path))

    def close(self):
        if self._tar is not None:
            self._tar.close()
            self._tar = None


def read_rgb(src: RasterSource, rel_path: str) -> np.ndarray:
    """uint8 [H, W, 3]."""
    img = src.read_image(rel_path)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[..., :3].astype(np.uint8)


def rgb_to_norm(rgb_u8: np.ndarray) -> np.ndarray:
    """[0,255] -> [-1,1] float32 (base_mtl_dataset.py:64,147)."""
    return (rgb_u8.astype(np.float32) / 255.0 * 2.0 - 1.0)


# ---------------------------------------------------------------------------
# Depth decoders
# ---------------------------------------------------------------------------

def decode_vkitti_depth(raw: np.ndarray) -> np.ndarray:
    """uint16 png / 100 -> meters, [H, W, 1] (vkitti_dataset.py:49-53)."""
    return (raw.astype(np.float32) / 100.0)[..., None]


def decode_hypersim_depth(raw: np.ndarray) -> np.ndarray:
    """uint16 png / 1000 -> meters (hypersim_dataset.py:27)."""
    return (raw.astype(np.float32) / 1000.0)[..., None]


def decode_kitti_depth(raw: np.ndarray) -> np.ndarray:
    """uint16 png / 256 -> meters; 0 = no lidar return
    (kitti_dataset.py:55-60)."""
    return (raw.astype(np.float32) / 256.0)[..., None]


# ---------------------------------------------------------------------------
# Flow decoders
# ---------------------------------------------------------------------------

def decode_vkitti_flow(bgr_u16: np.ndarray):
    """vKITTI 16-bit flow png -> (flow [H,W,2] f32 px, valid [H,W,1] bool).

    Channels (cv2 BGR order): b==0 flags invalid; g,r encode flow_y,x
    normalized by (h-1),(w-1) and scaled to [0, 2^16-1]
    (vkitti_dataset.py:96-131).
    """
    assert bgr_u16.dtype == np.uint16 and bgr_u16.shape[-1] == 3
    h, w, _ = bgr_u16.shape
    invalid = bgr_u16[..., 0] == 0
    flow = 2.0 / (2 ** 16 - 1.0) * bgr_u16[..., 2:0:-1].astype(np.float32) - 1
    flow[..., 0] *= w - 1
    flow[..., 1] *= h - 1
    flow[invalid] = 0
    return flow, (~invalid)[..., None]


def decode_vkitti_scene_flow(bgr_u16: np.ndarray) -> np.ndarray:
    """vKITTI 16-bit scene-flow png -> [H,W,3] meters x10
    (vkitti_dataset.py:167-185): all three channels map [0,2^16-1] ->
    [-1,1] * 10, channel order reversed (bgr -> xyz)."""
    assert bgr_u16.dtype == np.uint16 and bgr_u16.shape[-1] == 3
    flow = 2.0 / (2 ** 16 - 1.0) * bgr_u16[..., ::-1].astype(np.float32) - 1
    return flow * 10.0


def disp2pc(disp: np.ndarray, baseline: float, f: float, cx: float,
            cy: float, flow: Optional[np.ndarray] = None) -> np.ndarray:
    """Disparity -> camera-space point cloud [H,W,3].

    Single shared implementation of the pinhole back-projection used both by
    the FT3D offline preprocessing (reference
    dataset_preprocess/flying_things_3D/utils.py:319-345) and the KITTI flow
    2015 scene-flow derivation (kitti_flow_dataset.py:64-85). When `flow` is
    given, pixel coordinates are advected by it before back-projection
    (the second-frame point cloud of the scene-flow pair).
    """
    h, w = disp.shape
    depth = baseline * f / (disp + 1e-5)
    xx = np.tile(np.arange(w, dtype=np.float32)[None, :], (h, 1))
    yy = np.tile(np.arange(h, dtype=np.float32)[:, None], (1, w))
    if flow is None:
        x = (xx - cx) * depth / f
        y = (yy - cy) * depth / f
    else:
        x = (xx - cx + flow[..., 0]) * depth / f
        y = (yy - cy + flow[..., 1]) * depth / f
    return np.stack([x, y, depth], axis=-1)


def decode_ft3d_flow(bgr_u16: np.ndarray):
    """FlyingThings3D packed flow png -> (flow [H,W,2], valid [H,W,1]).

    Encoding (dataset_preprocess/flying_things_3D/utils.py:248-284):
    flow_img = (flow * 64 + 32768), mask in third channel.
    """
    assert bgr_u16.dtype == np.uint16
    flow = (bgr_u16[..., 2:0:-1].astype(np.float32) - 32768.0) / 64.0
    valid = (bgr_u16[..., 0] > 0)[..., None]
    flow[~valid[..., 0]] = 0
    return flow, valid


def save_flow_png_ft3d(path: str, flow: np.ndarray,
                       mask: Optional[np.ndarray] = None, scale: int = 64):
    """Inverse of decode_ft3d_flow (utils.py:248-266) for the offline
    preprocessing port."""
    h, w = flow.shape[:2]
    if mask is None:
        mask = np.ones((h, w), bool)
    out = np.zeros((h, w, 3), np.uint16)
    out[..., 2] = np.clip(flow[..., 0] * scale + 32768, 0, 65535)
    out[..., 1] = np.clip(flow[..., 1] * scale + 32768, 0, 65535)
    out[..., 0] = mask.squeeze().astype(np.uint16)
    cv2.imwrite(path, out)


def read_pfm(data: bytes) -> np.ndarray:
    """Portable FloatMap decode (FT3D disparities,
    dataset_preprocess/flying_things_3D/utils.py:182-219)."""
    stream = _io.BytesIO(data)
    header = stream.readline().rstrip()
    if header == b"PF":
        channels = 3
    elif header == b"Pf":
        channels = 1
    else:
        raise ValueError("not a PFM file")
    dims = stream.readline().split()
    w, h = int(dims[0]), int(dims[1])
    scale = float(stream.readline().rstrip())
    endian = "<" if scale < 0 else ">"
    img = np.frombuffer(stream.read(), endian + "f4")
    img = img.reshape((h, w, channels) if channels == 3 else (h, w))
    return np.flipud(img).copy()
