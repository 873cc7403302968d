"""Hypersim offline preprocessing: HDF5 -> training rasters.

Port of reference dataset_preprocess/hypersim/{preprocess_hypersim.py,
hypersim_util.py}: tone-mapped RGB png, plane depth (ray distance -> planar
depth via the 886.81 focal, x1000 uint16), camera-space normals oriented
toward the camera with the x-flip convention, albedo = reflectance, and
shading = rgb / reflectance. Requires h5py at call time only.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

IMG_WIDTH, IMG_HEIGHT = 1024, 768
FOCAL_LENGTH = 886.81  # preprocess_hypersim.py:19-21

GAMMA = 1.0 / 2.2
PERCENTILE = 90
BRIGHTNESS_DESIRED = 0.8

# known-corrupt frames excluded by the reference
# (preprocess_hypersim.py:23-28), keyed by rgb relative path
FILTERED_OUT = frozenset([
    "ai_004_009/rgb_cam_01_fr0000.png",
    "ai_008_001/rgb_cam_01_fr0000.png",
    "ai_008_001/rgb_cam_02_fr0000.png",
    "ai_011_005/rgb_cam_01_fr0000.png",
    "ai_016_009/rgb_cam_00_fr0000.png",
    "ai_052_002/rgb_cam_01_fr0021.png",
])


def brightness_ccir601(rgb: np.ndarray) -> np.ndarray:
    return 0.3 * rgb[..., 0] + 0.59 * rgb[..., 1] + 0.11 * rgb[..., 2]


def tonemap_scale(rgb: np.ndarray, valid_mask: Optional[np.ndarray] = None,
                  percentile: int = PERCENTILE) -> float:
    """Scale s.t. (scale * P_pct brightness)^gamma == 0.8
    (hypersim_util.py:132-177)."""
    b = brightness_ccir601(rgb)
    if valid_mask is not None:
        b = b[valid_mask]
    if b.size == 0:
        return 1.0
    cur = np.percentile(b, percentile)
    if cur < 1e-4:
        return 0.0
    return float(np.power(BRIGHTNESS_DESIRED, 1.0 / GAMMA) / cur)


def tone_map_hdr(rgb: np.ndarray,
                 valid_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """HDR linear RGB -> [0,1] tone-mapped (hypersim_util.py:44-83)."""
    scale = tonemap_scale(rgb, valid_mask)
    return np.clip(np.power(np.maximum(scale * rgb, 0), GAMMA), 0.0, 1.0)


def dist_to_depth(distance: np.ndarray, width: int = IMG_WIDTH,
                  height: int = IMG_HEIGHT,
                  focal: float = FOCAL_LENGTH) -> np.ndarray:
    """Ray distance from camera center -> planar depth
    (hypersim_util.py:87-104; apple/ml-hypersim#9)."""
    px = np.linspace(-0.5 * width + 0.5, 0.5 * width - 0.5,
                     width).reshape(1, width).repeat(height, 0)
    py = np.linspace(-0.5 * height + 0.5, 0.5 * height - 0.5,
                     height).reshape(height, 1).repeat(width, 1)
    plane = np.stack([px, py, np.full((height, width), focal)], axis=-1)
    return distance / np.linalg.norm(plane, axis=-1) * focal


def orient_normals_toward_camera(
        normal_cam: np.ndarray, normal_world: np.ndarray,
        position_world: np.ndarray, camera_position: np.ndarray,
        valid_mask: np.ndarray) -> np.ndarray:
    """Flip back-facing normals (n.v < 0) and apply the x-flip convention
    (preprocess_hypersim.py:332-355)."""
    to_cam = camera_position[None, None, :] - position_world
    to_cam = to_cam / np.maximum(
        np.linalg.norm(to_cam, axis=-1, keepdims=True), 1e-12)
    n_dot_v = np.sum(normal_world * to_cam, axis=-1)
    back = valid_mask & (n_dot_v < 0)
    out = normal_cam.copy()
    out[back] = -out[back]
    out[..., 0][valid_mask] = -out[..., 0][valid_mask]
    return out


def shading_from(rgb: np.ndarray, reflectance: np.ndarray,
                 eps: float = 1e-6) -> np.ndarray:
    """shading = rgb / reflectance (preprocess_hypersim.py:143-146)."""
    return rgb / np.maximum(reflectance, eps)


def _normalize_rows(a: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(a, axis=-1, keepdims=True)
    return a / np.maximum(n, 1e-12)


def process_frame(h5_scene_dir: str, frame_id: int, cam: str,
                  output_dir: str, scene_name: str = "") -> dict:
    """One-frame pipeline producing the reference's exact file layout
    (preprocess_hypersim.py:78-90 names, :140-360 processing): tone-mapped
    rgb png, plane depth x1000 uint16 png, camera-space normals oriented
    toward the camera (npy + png + valid-mask npy), albedo =
    tonemap_scale * reflectance, shading = rgb / reflectance. Returns the
    written relative paths (for filename-list building)."""
    import cv2
    import h5py

    def _read(name):
        sub = f"scene_{cam}_final_hdf5" \
            if name in ("color", "diffuse_reflectance") \
            else f"scene_{cam}_geometry_hdf5"
        path = os.path.join(h5_scene_dir, "images", sub,
                            f"frame.{frame_id:04d}.{name}.hdf5")
        with h5py.File(path, "r") as f:
            return np.array(f["dataset"])

    rgb = _read("color").astype(np.float64)
    entity = _read("render_entity_id")
    valid = entity != -1
    if not valid.any():
        # reference skips fully-invalid frames entirely
        # (preprocess_hypersim.py:140-142, :315-317)
        return None
    scale = tonemap_scale(rgb, valid)
    rgb_tm = np.clip(np.power(np.maximum(scale * rgb, 0), GAMMA), 0.0, 1.0)
    dist = _read("depth_meters")
    h, w = dist.shape[:2]
    depth = np.nan_to_num(dist_to_depth(dist, width=w, height=h), nan=0.0)
    depth[~valid] = 0

    out_scene = os.path.join(output_dir, scene_name)
    os.makedirs(out_scene, exist_ok=True)
    names = {k: f"{k}_{cam}_fr{frame_id:04d}" for k in
             ("rgb", "depth_plane", "normal_cam", "normal_valid_mask",
              "reflectance", "shading")}

    def _imwrite(base, arr_u8):
        cv2.imwrite(os.path.join(out_scene, base),
                    cv2.cvtColor(arr_u8, cv2.COLOR_RGB2BGR)
                    if arr_u8.ndim == 3 else arr_u8)

    _imwrite(names["rgb"] + ".png", (rgb_tm * 255).astype(np.uint8))
    _imwrite(names["depth_plane"] + ".png",
             (depth * 1000).astype(np.uint16))

    # albedo / shading (preprocess_hypersim.py:140-158)
    reflectance = _read("diffuse_reflectance").astype(np.float64)
    _imwrite(names["shading"] + ".png",
             (np.clip(shading_from(rgb, reflectance), 0, 1) * 255)
             .astype(np.uint8))
    # the datasets derive this path as rgb.replace('rgb','reflectance')
    # (datasets.py HypersimAlbedo/ShadingDataset) — the raster must be
    # named reflectance_*, like the reference's deployed trees
    _imwrite(names["reflectance"] + ".png",
             (np.clip(scale * reflectance, 0, 1) * 255).astype(np.uint8))

    # normals: sentinel-fill invalid rows BEFORE normalizing (reference
    # :319-336 sets -987654321 then sklearn-normalizes — NaN/inf source
    # values at invalid pixels must never reach the saved npy), then
    # normalize, orient toward camera, x-flip (:286-355)
    normal_cam = _read("normal_cam").astype(np.float64)
    normal_world = _read("normal_world").astype(np.float64)
    position = _read("position").astype(np.float64)
    nvalid = valid & np.isfinite(position).all(-1) \
        & np.isfinite(normal_cam).all(-1) \
        & np.isfinite(normal_world).all(-1) \
        & ~np.isclose(np.nan_to_num(normal_cam), 0.0).all(-1) \
        & ~np.isclose(np.nan_to_num(normal_world), 0.0).all(-1)
    normal_cam[~nvalid] = -987654321.0
    normal_world[~nvalid] = -987654321.0
    normal_cam = _normalize_rows(normal_cam)
    normal_world = _normalize_rows(normal_world)
    with h5py.File(os.path.join(h5_scene_dir, "_detail", cam,
                                "camera_keyframe_positions.hdf5"), "r") as f:
        cam_pos = np.array(f["dataset"])[frame_id]
    position = np.nan_to_num(position, nan=0.0, posinf=0.0, neginf=0.0)
    normal_cam = orient_normals_toward_camera(
        normal_cam, normal_world, position, cam_pos, nvalid)
    np.save(os.path.join(out_scene, names["normal_cam"] + ".npy"),
            normal_cam.astype(np.float32))
    np.save(os.path.join(out_scene, names["normal_valid_mask"] + ".npy"),
            nvalid)
    _imwrite(names["normal_cam"] + ".png",
             ((normal_cam * 0.5 + 0.5) * 255).clip(0, 255).astype(np.uint8))

    join = (lambda n: os.path.join(scene_name, n) if scene_name else n)
    return {"rgb": join(names["rgb"] + ".png"),
            "depth": join(names["depth_plane"] + ".png"),
            "normal": join(names["normal_cam"] + ".npy"),
            "normal_png": join(names["normal_cam"] + ".png"),
            "normal_mask": join(names["normal_valid_mask"] + ".npy"),
            "albedo": join(names["reflectance"] + ".png"),
            "shading": join(names["shading"] + ".png")}


def discover_frames(dataset_dir: str):
    """Walk <dataset_dir>/<scene>/images/scene_<cam>_final_hdf5/
    frame.NNNN.color.hdf5 -> (scene, cam, frame_id) triples."""
    import re

    for scene in sorted(os.listdir(dataset_dir)):
        images = os.path.join(dataset_dir, scene, "images")
        if not os.path.isdir(images):
            continue
        for sub in sorted(os.listdir(images)):
            m = re.fullmatch(r"scene_(cam_\d+)_final_hdf5", sub)
            if not m:
                continue
            for fname in sorted(os.listdir(os.path.join(images, sub))):
                fm = re.fullmatch(r"frame\.(\d+)\.color\.hdf5", fname)
                if fm:
                    yield scene, m.group(1), int(fm.group(1))


def regenerate_no_nan_split(filename_lines, nan_lines):
    """Filter a hypersim filename list by the NaN-depth list (reference
    remove_nan_depth.py:24-73). filename lines: 'rgb depth ...' relative
    paths; nan lines: raw HDF5 paths like .../<scene>/images/
    scene_cam_XX_geometry_hdf5/frame.NNNN.depth_meters.hdf5."""
    nan_info = set()
    for line in nan_lines:
        line = line.strip().split()[0] if line.strip() else ""
        if not line:
            continue
        parts = line.split("/")
        scene = parts[3]
        camera = "_".join(parts[-2].split("_")[1:3])
        frame = parts[-1].split(".")[1]
        nan_info.add((scene, camera, frame))
    kept = []
    for line in filename_lines:
        line = line.rstrip("\n")
        if not line.strip():
            continue
        depth_path = line.split()[1]
        scene = depth_path.split("/")[0]
        fname = depth_path.split("/")[1]
        camera = fname.split("depth_plane_")[1].split("_fr")[0]
        frame = fname.split("_fr")[1].split(".")[0]
        if (scene, camera, frame) not in nan_info:
            kept.append(line)
    return kept


def main(argv=None):
    """Batch driver (reference preprocess_hypersim.py / remove_nan_depth.py).

    frames mode:  python -m stablemtl_tpu_torch.preprocess.hypersim frames \\
                      --dataset_dir <scenes> --output_dir <out> [--csv meta]
    split mode:   ... regen_split --filename_list a.txt --nan_list b.txt \\
                      --out filtered.txt
    """
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    sub = ap.add_subparsers(dest="mode", required=True)
    fr = sub.add_parser("frames")
    fr.add_argument("--dataset_dir", required=True)
    fr.add_argument("--output_dir", required=True)
    fr.add_argument("--csv", default=None,
                    help="metadata_images_split_scene CSV (scene_name, "
                         "camera_name, frame_id, split_partition_name); "
                         "default: scan the directory tree")
    fr.add_argument("--split", default="train")
    fr.add_argument("--process_id", type=int, default=0)
    fr.add_argument("--n_processes", type=int, default=1)
    rg = sub.add_parser("regen_split")
    rg.add_argument("--filename_list", required=True)
    rg.add_argument("--nan_list", required=True)
    rg.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    if args.mode == "regen_split":
        with open(args.filename_list) as f:
            lines = f.readlines()
        with open(args.nan_list) as f:
            nans = f.readlines()
        kept = regenerate_no_nan_split(lines, nans)
        with open(args.out, "w") as f:
            f.write("\n".join(kept) + "\n")
        print(f"{len(lines)} -> {len(kept)} entries ({args.out})")
        return

    if args.csv:
        import pandas as pd

        df = pd.read_csv(args.csv)
        if "included_in_public_release" in df.columns:
            df = df[df.included_in_public_release]  # reference :50
        df = df[df.split_partition_name == args.split]
        triples = [(r.scene_name, r.camera_name, int(r.frame_id))
                   for r in df.itertuples()]
    else:
        triples = list(discover_frames(args.dataset_dir))
    triples = triples[args.process_id::args.n_processes]
    out_split = os.path.join(args.output_dir, args.split)
    lines = []
    for scene, cam, fid in triples:
        rgb_rel = f"{scene}/rgb_{cam}_fr{fid:04d}.png"
        if rgb_rel in FILTERED_OUT:  # reference blacklist (:23-28, :98)
            print(f"skipping blacklisted {rgb_rel}", flush=True)
            continue
        rels = process_frame(os.path.join(args.dataset_dir, scene),
                             fid, cam, out_split, scene_name=scene)
        if rels is None:
            print(f"skipping {rgb_rel}: no valid pixels", flush=True)
            continue
        # reference column order (data_split/hypersim lists):
        # rgb depth normal_npy normal_png normal_mask; albedo/shading
        # are derived from the rgb path by the datasets
        lines.append(" ".join([rels["rgb"], rels["depth"], rels["normal"],
                               rels["normal_png"], rels["normal_mask"]]))
        print(f"processed {scene}/{cam}/fr{fid:04d}", flush=True)
    list_path = os.path.join(args.output_dir,
                             f"filename_list_{args.split}.txt")
    if args.n_processes > 1:
        # shards must not overwrite each other's list; concatenate the
        # parts when all shards are done
        list_path += f".part{args.process_id:02d}of{args.n_processes:02d}"
    with open(list_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {list_path} ({len(lines)} frames)")


if __name__ == "__main__":
    main()
