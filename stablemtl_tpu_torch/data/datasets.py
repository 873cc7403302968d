"""The 15 concrete datasets + registry.

Behavioral parity with reference src/dataset/*_dataset.py and
the registry in src/dataset/__init__.py:17-64. Everything is channels-last
numpy; path-derivation rules (replace 'depth'->'rgb' etc.) are preserved so
the reference's data_split/ filename lists work verbatim.

Copy of `stablemtl_tpu/data/datasets.py`: the port keeps its
own so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..utils.normalizers import normalize_optical_flow, normalize_scene_flow
from .augmentation import (
    joint_albedo_or_shading_augmentation,
    joint_depth_augmentation,
    joint_normal_augmentation,
    joint_optical_flow_augmentation,
    joint_scene_flow_augmentation,
    joint_semseg_augmentation,
)
from .base import (
    OUTPUT_FIELD,
    OUTPUT_TYPE_FIELD,
    VALID_MASK_FIELD,
    DatasetMode,
    MTLDataset,
    eval_crop_mask,
    kitti_benchmark_crop,
    resize_nearest,
)
from .io import (
    decode_ft3d_flow,
    decode_hypersim_depth,
    decode_kitti_depth,
    decode_vkitti_depth,
    decode_vkitti_flow,
    decode_vkitti_scene_flow,
    disp2pc,
    read_rgb,
    rgb_to_norm,
)
from .semantic import CityscapesEncoder, VKitti2Encoder


def get_brightness(rgb: np.ndarray) -> np.ndarray:
    """CCIR601 YIQ brightness, keepdim (reference dataset/utils.py:5-24)."""
    return (0.3 * rgb[..., 0] + 0.59 * rgb[..., 1]
            + 0.11 * rgb[..., 2])[..., None]


# ---------------------------------------------------------------------------
# Hypersim (depth / normal / albedo / shading)
# ---------------------------------------------------------------------------

class HypersimDataset(MTLDataset):
    """min_depth 1e-5, max_depth 65 (hypersim_dataset.py:15-22)."""

    def __init__(self, **kw):
        kw.setdefault("min_depth", 1e-5)
        kw.setdefault("max_depth", 65.0)
        super().__init__(**kw)

    def _paths(self, index):
        # line: rgb depth normal_npy _ normal_valid_mask
        return self.filenames[index]


class HypersimDepthDataset(HypersimDataset):
    output_type = "depth"

    def _get_data_item(self, index, rng):
        rgb_rel, depth_rel = self._paths(index)[:2]
        img = self._rgb(rgb_rel)
        depth = decode_hypersim_depth(self.src.read_image(depth_rel))
        mask = self._depth_valid_mask(depth)
        img, depth, mask = joint_depth_augmentation(
            img, depth, mask, self.augmentation, rng)
        out = {"rgb_norm": rgb_to_norm(img),
               "depth_raw_linear": depth, VALID_MASK_FIELD: mask}
        if self.mode == DatasetMode.TRAIN:
            out[OUTPUT_FIELD] = self.depth_normalizer(depth, mask)
        return out


class HypersimNormalDataset(HypersimDataset):
    output_type = "normal"

    def _get_data_item(self, index, rng):
        line = self._paths(index)
        rgb_rel, _, normal_rel, _, normal_mask_rel = line[:5]
        img = self._rgb(rgb_rel)
        normal = self.src.read_npy(normal_rel).astype(np.float32)  # HWC
        mask = self.src.read_npy(normal_mask_rel)
        if mask.ndim == 2:
            mask = mask[..., None]
        img, normal, mask = joint_normal_augmentation(
            img, normal, mask.astype(bool), self.augmentation, rng)
        return {"rgb_norm": rgb_to_norm(img), OUTPUT_FIELD: normal,
                "normal": normal, VALID_MASK_FIELD: mask}


class HypersimAlbedoDataset(HypersimDataset):
    output_type = "albedo"

    def _get_data_item(self, index, rng):
        rgb_rel = self._paths(index)[0]
        albedo_rel = rgb_rel.replace("rgb", "reflectance")
        img = self._rgb(rgb_rel)
        albedo = self._rgb(albedo_rel).astype(np.float32)
        mask = self.albedo_valid_mask(albedo)
        if self.mode == DatasetMode.TRAIN:
            img, albedo, mask = joint_albedo_or_shading_augmentation(
                img, albedo, mask, self.augmentation, rng)
            return {"rgb_norm": rgb_to_norm(img),
                    OUTPUT_FIELD: albedo / 255.0 * 2.0 - 1.0,
                    VALID_MASK_FIELD: mask}
        return {"rgb_norm": rgb_to_norm(img), "albedo": albedo / 255.0,
                VALID_MASK_FIELD: mask, "albedo_valid_mask": mask}


class HypersimShadingDataset(HypersimDataset):
    output_type = "shading"

    def _get_data_item(self, index, rng):
        rgb_rel = self._paths(index)[0]
        shading_rel = rgb_rel.replace("rgb", "shading")
        albedo_rel = rgb_rel.replace("rgb", "reflectance")
        img = self._rgb(rgb_rel)
        shading = get_brightness(self._rgb(shading_rel).astype(np.float32))
        albedo = self._rgb(albedo_rel).astype(np.float32)
        mask = self.albedo_valid_mask(albedo)
        if self.mode == DatasetMode.TRAIN:
            img, shading, mask = joint_albedo_or_shading_augmentation(
                img, shading, mask, self.augmentation, rng)
            return {"rgb_norm": rgb_to_norm(img),
                    OUTPUT_FIELD: shading / 255.0 * 2.0 - 1.0,
                    VALID_MASK_FIELD: mask}
        return {"rgb_norm": rgb_to_norm(img), "shading": shading / 255.0,
                VALID_MASK_FIELD: mask, "shading_valid_mask": mask}


# ---------------------------------------------------------------------------
# Virtual KITTI 2 (depth / normal / semantic / optical flow / scene flow)
# ---------------------------------------------------------------------------

class VirtualKITTIDataset(MTLDataset):
    """min_depth 1e-5, max_depth 80; garg/eigen eval crops
    (vkitti_dataset.py:19-88)."""

    def __init__(self, kitti_bm_crop=False, valid_mask_crop=None, **kw):
        kw.setdefault("min_depth", 1e-5)
        kw.setdefault("max_depth", 80.0)
        super().__init__(**kw)
        self.kitti_bm_crop = kitti_bm_crop
        assert valid_mask_crop in (None, "garg", "eigen")
        self.valid_mask_crop = valid_mask_crop
        self.semantic_encoder = VKitti2Encoder(n_classes=8)

    def _depth_valid_mask(self, depth):
        mask = super()._depth_valid_mask(depth)
        if self.valid_mask_crop is not None:
            mask &= eval_crop_mask(mask.shape[:2],
                                   self.valid_mask_crop)[..., None]
        return mask

    def _read_depth(self, rel):
        return decode_vkitti_depth(self.src.read_image(rel))


class VirtualKITTIDepthDataset(VirtualKITTIDataset):
    output_type = "depth"

    def _get_data_item(self, index, rng):
        depth_rel = self.filenames[index][0]
        rgb_rel = depth_rel.replace("depth", "rgb").replace("png", "jpg")
        img = self._rgb(rgb_rel)
        depth = self._read_depth(depth_rel)
        mask = self._depth_valid_mask(depth)
        img, depth, mask = joint_depth_augmentation(
            img, depth, mask, self.augmentation, rng)
        if self.mode == DatasetMode.EVAL and self.kitti_bm_crop:
            img, depth, mask = (kitti_benchmark_crop(a)
                                for a in (img, depth, mask))
        out = {"rgb_norm": rgb_to_norm(img),
               "depth_raw_linear": depth, VALID_MASK_FIELD: mask}
        if self.mode == DatasetMode.TRAIN:
            out[OUTPUT_FIELD] = self.depth_normalizer(depth, mask)
        return out


class VirtualKITTINormalDataset(VirtualKITTIDataset):
    output_type = "normal"

    def _get_data_item(self, index, rng):
        normal_rel = self.filenames[index][0]
        rgb_rel = normal_rel.replace("normal_estimated", "original") \
            .replace("normal", "rgb").replace("npy", "jpg")
        depth_rel = rgb_rel.replace("rgb", "depth").replace("jpg", "png")
        img = self._rgb(rgb_rel)
        normal = self.src.read_npy(normal_rel).astype(np.float32)
        depth = self._read_depth(depth_rel)
        mask = self._depth_valid_mask(depth)
        img, normal, mask = joint_normal_augmentation(
            img, normal, mask, self.augmentation, rng)
        return {"rgb_norm": rgb_to_norm(img), OUTPUT_FIELD: normal,
                "normal": normal, VALID_MASK_FIELD: mask}


class VirtualKITTISemsegDataset(VirtualKITTIDataset):
    output_type = "semantic"

    def _get_data_item(self, index, rng):
        sem_rel = self.filenames[index][0]
        rgb_rel = sem_rel.replace("classSegmentation", "rgb") \
            .replace("png", "jpg").replace("classgt", "rgb")
        img = self._rgb(rgb_rel)
        sem_rgb = np.asarray(self.src.read_image(sem_rel),
                             np.uint8)[..., :3]
        class_id = self.semantic_encoder.encode_segmap(sem_rgb)
        sem_color = self.semantic_encoder.segmap2color(class_id)
        sem_norm = sem_color.astype(np.float32) / 255.0 * 2.0 - 1.0
        mask = (class_id != self.semantic_encoder.ignore_index)[..., None]
        img, sem_norm, mask = joint_semseg_augmentation(
            img, sem_norm, mask, self.augmentation, rng)
        return {"rgb_norm": rgb_to_norm(img), OUTPUT_FIELD: sem_norm,
                "semantic_class_id": class_id[..., None],
                VALID_MASK_FIELD: mask}


class VirtualKITTIOpticalFlowDataset(VirtualKITTIDataset):
    output_type = "optical_flow"

    def _flow_paths(self, index):
        flow_rel = self.filenames[index][0]
        rgb_rel = flow_rel.replace("forwardFlow", "rgb") \
            .replace("png", "jpg").replace("flow", "rgb")
        frame_id = int(rgb_rel.split("/")[-1].split("_")[-1]
                       .replace(".jpg", ""))
        next_rgb_rel = rgb_rel.replace(f"_{frame_id:05d}",
                                       f"_{frame_id + 1:05d}")
        return rgb_rel, next_rgb_rel, flow_rel

    def _get_data_item(self, index, rng):
        rgb_rel, next_rgb_rel, flow_rel = self._flow_paths(index)
        flow, mask = decode_vkitti_flow(self.src.read_image_cv2(flow_rel))
        img0 = self._rgb(rgb_rel)
        img1 = self._rgb(next_rgb_rel)
        if self.mode == DatasetMode.TRAIN:
            img0, img1, flow, mask = joint_optical_flow_augmentation(
                img0, img1, flow, mask, self.augmentation, rng)
        if self.mode == DatasetMode.EVAL and self.kitti_bm_crop:
            img0, img1, flow, mask = (kitti_benchmark_crop(a)
                                      for a in (img0, img1, flow, mask))
        return {"rgb_norm": rgb_to_norm(img0),
                "rgb_next_norm": rgb_to_norm(img1),
                OUTPUT_FIELD: normalize_optical_flow(flow, "hw",
                                                     channel_axis=-1),
                "optical_flow_raw": flow, VALID_MASK_FIELD: mask}


class VirtualKITTISceneFlowDataset(VirtualKITTIDataset):
    output_type = "scene_flow"

    def _get_data_item(self, index, rng):
        sf_rel = self.filenames[index][0]
        rgb_rel = sf_rel.replace("forwardSceneFlow", "rgb") \
            .replace("png", "jpg").replace("sceneFlow", "rgb")
        flow_rel = sf_rel.replace("forwardSceneFlow", "forwardFlow") \
            .replace("sceneFlow", "flow")
        frame_id = int(rgb_rel.split("/")[-1].split("_")[-1]
                       .replace(".jpg", ""))
        next_rgb_rel = rgb_rel.replace(f"_{frame_id:05d}",
                                       f"_{frame_id + 1:05d}")
        img0, img1 = self._rgb(rgb_rel), self._rgb(next_rgb_rel)
        scene_flow = decode_vkitti_scene_flow(self.src.read_image_cv2(sf_rel))
        _, mask = decode_vkitti_flow(self.src.read_image_cv2(flow_rel))
        if self.mode == DatasetMode.TRAIN:
            img0, img1, scene_flow, mask = joint_scene_flow_augmentation(
                img0, img1, scene_flow, mask, self.augmentation, rng)
        return {"rgb_norm": rgb_to_norm(img0),
                "rgb_next_norm": rgb_to_norm(img1),
                OUTPUT_FIELD: normalize_scene_flow(scene_flow, "hw",
                                                   channel_axis=-1),
                "scene_flow": scene_flow, VALID_MASK_FIELD: mask}


# ---------------------------------------------------------------------------
# KITTI (eigen depth eval)
# ---------------------------------------------------------------------------

class KITTIDataset(MTLDataset):
    """min 1e-5, max 80, depth png/256, garg/eigen masks, benchmark crop
    (kitti_dataset.py:7-83)."""

    output_type = "depth"

    def __init__(self, kitti_bm_crop=True, valid_mask_crop="eigen", **kw):
        kw.setdefault("min_depth", 1e-5)
        kw.setdefault("max_depth", 80.0)
        super().__init__(**kw)
        self.kitti_bm_crop = kitti_bm_crop
        assert valid_mask_crop in (None, "garg", "eigen")
        self.valid_mask_crop = valid_mask_crop
        self.filenames = [f for f in self.filenames if f[1] != "None"]

    def _get_data_item(self, index, rng):
        rgb_rel, depth_rel = self.filenames[index][:2]
        img = self._rgb(rgb_rel)
        depth = decode_kitti_depth(self.src.read_image(depth_rel))
        mask = self._depth_valid_mask(depth)
        if self.valid_mask_crop is not None:
            mask &= eval_crop_mask(mask.shape[:2],
                                   self.valid_mask_crop)[..., None]
        if self.kitti_bm_crop:
            img, depth, mask = (kitti_benchmark_crop(a)
                                for a in (img, depth, mask))
        return {"rgb_norm": rgb_to_norm(img), "depth_raw_linear": depth,
                VALID_MASK_FIELD: mask}


# ---------------------------------------------------------------------------
# DIODE (depth + normal eval)
# ---------------------------------------------------------------------------

class DIODEDataset(MTLDataset):
    """min 0.6, max 350; normal axis flips z,y then invert; valid where
    0.5 < |n| < 1.5 (diode_dataset.py:11-61)."""

    output_type = "depth"

    def __init__(self, **kw):
        kw.setdefault("min_depth", 0.6)
        kw.setdefault("max_depth", 350.0)
        super().__init__(**kw)

    def _get_data_item(self, index, rng):
        rgb_rel, depth_rel, mask_rel = self.filenames[index][:3]
        normal_rel = depth_rel.replace("_depth", "_normal")
        img = self._rgb(rgb_rel)
        depth = self.src.read_npy(depth_rel).squeeze()[..., None] \
            .astype(np.float32)
        depth_mask = self.src.read_npy(mask_rel).squeeze()[..., None] \
            .astype(bool)
        normal = self.src.read_npy(normal_rel).squeeze().astype(np.float32)
        normal[..., 2] *= -1
        normal[..., 1] *= -1
        normal = -normal
        nnorm = np.linalg.norm(normal, axis=-1, keepdims=True)
        normal_mask = (nnorm > 0.5) & (nnorm < 1.5)
        return {"rgb_norm": rgb_to_norm(img),
                "depth_raw_linear": depth, VALID_MASK_FIELD: depth_mask,
                "normal": normal, "normal_valid_mask": normal_mask}


# ---------------------------------------------------------------------------
# Cityscapes (semantic eval, half-res)
# ---------------------------------------------------------------------------

class CityscapesDataset(MTLDataset):
    output_type = "semantic"

    def __init__(self, **kw):
        super().__init__(**kw)
        self.semantic_encoder = CityscapesEncoder(n_classes=8)

    def _half(self, img):
        return resize_nearest(img, (img.shape[0] // 2, img.shape[1] // 2))

    def _get_data_item(self, index, rng):
        rgb_rel = self.filenames[index][0]
        sem_rel = rgb_rel.replace("leftImg8bit/", "gtFine/") \
            .replace("leftImg8bit", "gtFine_labelIds")
        img = self._half(self._rgb(rgb_rel))
        sem_id = self._half(np.asarray(self.src.read_image(sem_rel),
                                       np.uint8))
        if sem_id.ndim == 3:
            sem_id = sem_id[..., 0]
        class_id = self.semantic_encoder.encode_segmap(sem_id)
        sem_color = self.semantic_encoder.segmap2color(class_id)
        sem_norm = sem_color.astype(np.float32) / 255.0 * 2.0 - 1.0
        mask = (class_id != self.semantic_encoder.ignore_index)[..., None]
        return {"rgb_norm": rgb_to_norm(img), OUTPUT_FIELD: sem_norm,
                "semantic_class_id": class_id[..., None],
                VALID_MASK_FIELD: mask}


# ---------------------------------------------------------------------------
# KITTI flow 2015 (optical flow + derived scene flow eval)
# ---------------------------------------------------------------------------

class KittiFlowDataset(MTLDataset):
    """flow_occ 16-bit png + disparity->point-cloud->scene-flow derivation
    with baseline 0.54 (kitti_flow_dataset.py:40-142)."""

    output_type = "optical_flow"

    @staticmethod
    def load_calib(text: str) -> np.ndarray:
        for line in text.splitlines():
            if line.startswith("P_rect_02"):
                vals = [float(v) for v in line.split()[1:]]
                return np.array(vals, np.float32).reshape(3, 4)
        raise ValueError("P_rect_02 not found")

    # shared pinhole back-projection (data.io.disp2pc; the reference
    # duplicates it in kitti_flow_dataset.py:64-85 and FT3D utils.py:319)
    disp2pc = staticmethod(disp2pc)

    def _get_data_item(self, index, rng):
        flow_rel = self.filenames[index][0]
        rgb_rel = flow_rel.replace("flow_occ/", "image_2/")
        next_rgb_rel = rgb_rel.replace("_10", "_11")
        disp1_rel = flow_rel.replace("flow_occ/", "disp_occ_0/")
        disp2_rel = flow_rel.replace("flow_occ/", "disp_occ_1/")
        calib_rel = flow_rel.replace("flow_occ/", "calib_cam_to_cam/") \
            .replace(".png", ".txt").replace("_10", "")

        img0 = kitti_benchmark_crop(self._rgb(rgb_rel))
        img1 = kitti_benchmark_crop(self._rgb(next_rgb_rel))

        flow, flow_mask = decode_ft3d_flow(self.src.read_image_cv2(flow_rel))

        disp1_raw = self.src.read_image_cv2(disp1_rel)
        disp2_raw = self.src.read_image_cv2(disp2_rel)
        m1 = disp1_raw > 0
        m2 = disp2_raw > 0
        disp1 = disp1_raw.astype(np.float32) / 256.0
        disp2 = disp2_raw.astype(np.float32) / 256.0
        disp1[~m1] = -1.0
        disp2[~m2] = -1.0

        with open(os.path.join(self.dataset_dir, calib_rel)) as f:
            proj = self.load_calib(f.read())
        fx, cx, cy = proj[0, 0], proj[0, 2], proj[1, 2]
        pc1 = self.disp2pc(disp1, 0.54, fx, cx, cy)
        pc2 = self.disp2pc(disp2, 0.54, fx, cx, cy, flow=flow)
        scene_flow = (pc2 - pc1).astype(np.float32)
        sf_mask = (m1 & m2 & flow_mask[..., 0])[..., None]

        flow = kitti_benchmark_crop(flow)
        flow_mask = kitti_benchmark_crop(flow_mask)
        scene_flow = kitti_benchmark_crop(scene_flow)
        sf_mask = kitti_benchmark_crop(sf_mask)

        return {"rgb_norm": rgb_to_norm(img0),
                "rgb_next_norm": rgb_to_norm(img1),
                "optical_flow_raw": flow, VALID_MASK_FIELD: flow_mask,
                "scene_flow": scene_flow, "scene_flow_valid_mask": sf_mask}


# ---------------------------------------------------------------------------
# FlyingThings3D (optical flow / scene flow train)
# ---------------------------------------------------------------------------

class FlyingThings3DDataset(MTLDataset):
    CROP_W, CROP_H = 960, 536
    F, CX, CY = 1050.0, 479.5, 269.5  # flyingthings3d_dataset.py:27-28

    def _center_crop(self, img):
        sw = (img.shape[1] - self.CROP_W) // 2
        sh = (img.shape[0] - self.CROP_H) // 2
        return img[sh: sh + self.CROP_H, sw: sw + self.CROP_W]

    def _flow_paths(self, index):
        flow_rel = self.filenames[index][0]
        rgb_rel = flow_rel.replace("flow_2d", "image_clean")
        frame_id = int(rgb_rel.split("/")[-1].split("_")[-1]
                       .replace(".png", ""))
        next_rgb_rel = rgb_rel.replace(f"{frame_id:07d}",
                                       f"{frame_id + 1:07d}")
        return rgb_rel, next_rgb_rel, flow_rel


class FlyingThings3DOpticalFlowDataset(FlyingThings3DDataset):
    output_type = "optical_flow"

    def _get_data_item(self, index, rng):
        rgb_rel, next_rgb_rel, flow_rel = self._flow_paths(index)
        flow, mask = decode_ft3d_flow(self.src.read_image_cv2(flow_rel))
        img0 = self._center_crop(self._rgb(rgb_rel))
        img1 = self._center_crop(self._rgb(next_rgb_rel))
        flow = self._center_crop(flow)
        mask = self._center_crop(mask)
        if self.mode == DatasetMode.TRAIN:
            img0, img1, flow, mask = joint_optical_flow_augmentation(
                img0, img1, flow, mask, self.augmentation, rng)
        return {"rgb_norm": rgb_to_norm(img0),
                "rgb_next_norm": rgb_to_norm(img1),
                OUTPUT_FIELD: normalize_optical_flow(flow, "hw",
                                                     channel_axis=-1),
                "optical_flow_raw": flow, VALID_MASK_FIELD: mask}


class FlyingThings3DSceneFlowDataset(FlyingThings3DDataset):
    output_type = "scene_flow"

    def project_flow_3d_to_2d(self, flow_3d, pc, h, w):
        """Scatter per-point 3D flow into the image plane
        (flyingthings3d_dataset.py:157-181)."""
        x, y, depth = pc[..., 0], pc[..., 1], pc[..., 2]
        ix = np.round(self.CX + (self.F / depth) * x).astype(np.int32)
        iy = np.round(self.CY + (self.F / depth) * y).astype(np.int32)
        ok = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        ix, iy, flow_3d = ix[ok], iy[ok], flow_3d[ok]
        mask = np.zeros((h, w, 1), bool)
        mask[iy, ix, 0] = True
        out = np.zeros((h, w, 3), np.float32)
        out[iy, ix] = flow_3d
        return out, mask

    def _get_data_item(self, index, rng):
        rgb_rel, next_rgb_rel, flow_rel = self._flow_paths(index)
        pc_rel = rgb_rel.replace("image_clean", "pc").replace(".png", ".npz")
        f3d_rel = rgb_rel.replace("image_clean", "flow_3d") \
            .replace(".png", ".npy")
        img0 = self._center_crop(self._rgb(rgb_rel))
        img1 = self._center_crop(self._rgb(next_rgb_rel))
        pc1 = self.src.read_npy(pc_rel)["pc1"]
        flow_3d = self.src.read_npy(f3d_rel)
        h, w = img0.shape[:2]
        scene_flow, mask = self.project_flow_3d_to_2d(flow_3d, pc1, h, w)
        if self.mode == DatasetMode.TRAIN:
            img0, img1, scene_flow, mask = joint_scene_flow_augmentation(
                img0, img1, scene_flow, mask, self.augmentation, rng)
        return {"rgb_norm": rgb_to_norm(img0),
                "rgb_next_norm": rgb_to_norm(img1),
                OUTPUT_FIELD: normalize_scene_flow(scene_flow, "hw",
                                                   channel_axis=-1),
                "scene_flow": scene_flow, VALID_MASK_FIELD: mask}


# ---------------------------------------------------------------------------
# MID-Intrinsics (albedo + shading eval)
# ---------------------------------------------------------------------------

class MIDIntrinsicDataset(MTLDataset):
    output_type = "albedo"

    def _get_data_item(self, index, rng):
        rgb_rel = self.filenames[index][0]
        shading_rel = rgb_rel.replace(".jpg", "_shading.jpg")
        albedo_rel = rgb_rel.replace(".jpg", "_albedo.jpg")
        img = self._rgb(rgb_rel)
        albedo = self._rgb(albedo_rel).astype(np.float32) / 255.0
        mask = self.albedo_valid_mask(albedo)
        shading = get_brightness(
            self._rgb(shading_rel).astype(np.float32) / 255.0)
        return {"rgb_norm": rgb_to_norm(img),
                "albedo": albedo, "albedo_valid_mask": mask,
                "shading": shading, "shading_valid_mask": mask,
                VALID_MASK_FIELD: mask}


# ---------------------------------------------------------------------------
# Registry (reference src/dataset/__init__.py:17-35)
# ---------------------------------------------------------------------------

DATASET_REGISTRY = {
    "hypersim_normal": HypersimNormalDataset,
    "hypersim_depth": HypersimDepthDataset,
    "hypersim_albedo": HypersimAlbedoDataset,
    "hypersim_shading": HypersimShadingDataset,
    "vkitti": VirtualKITTIDataset,
    "vkitti_depth": VirtualKITTIDepthDataset,
    "vkitti_normal": VirtualKITTINormalDataset,
    "vkitti_semantic": VirtualKITTISemsegDataset,
    "vkitti_optical_flow": VirtualKITTIOpticalFlowDataset,
    "vkitti_scene_flow": VirtualKITTISceneFlowDataset,
    "kitti": KITTIDataset,
    "diode": DIODEDataset,
    "cityscapes": CityscapesDataset,
    "kitti_flow": KittiFlowDataset,
    "flying_things_3D_optical_flow": FlyingThings3DOpticalFlowDataset,
    "flying_things_3D_scene_flow": FlyingThings3DSceneFlowDataset,
    "mid_intrinsic": MIDIntrinsicDataset,
}


def get_dataset(cfg, base_data_dir: str, mode: DatasetMode, **kwargs):
    """Registry constructor (reference src/dataset/__init__.py:38-64).

    cfg is a mapping with at least {name, dir, filenames}; 'mixed' returns a
    list of member datasets.
    """
    name = cfg["name"] if hasattr(cfg, "__getitem__") else cfg.name
    if name == "mixed":
        assert mode == DatasetMode.TRAIN
        return [get_dataset(c, base_data_dir, mode, **kwargs)
                for c in cfg["dataset_list"]]
    cls = DATASET_REGISTRY[name]
    extra = {k: v for k, v in dict(cfg).items()
             if k not in ("name", "dir", "filenames")}
    extra.update(kwargs)
    return cls(mode=mode, filename_ls_path=cfg["filenames"],
               dataset_dir=os.path.join(base_data_dir, cfg["dir"]), **extra)
