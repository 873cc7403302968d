"""FlyingThings3D offline packing: disparities -> point clouds, 3D flow,
16-bit flow PNGs.

Port of reference dataset_preprocess/flying_things_3D/{preprocess.py,utils.py}:
- disp2pc with baseline 1.0, f 1050, (cx, cy) = (479.5, 269.5)
- flow_3d = disp2pc(disp1 + disp1_change, flow) - pc1
- 2D flow masked at |flow| < 500 px and packed (flow*64 + 32768) uint16
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..data.io import disp2pc as _disp2pc_shared
from ..data.io import read_pfm, save_flow_png_ft3d

BASELINE, FOCAL, CX, CY = 1.0, 1050.0, 479.5, 269.5
MAX_FLOW_PX = 500.0


def disp2pc(disp: np.ndarray, baseline: float = BASELINE,
            f: float = FOCAL, cx: float = CX, cy: float = CY,
            flow: Optional[np.ndarray] = None) -> np.ndarray:
    """FT3D-intrinsics wrapper over the shared back-projection
    (data.io.disp2pc; utils.py:319-345)."""
    return _disp2pc_shared(disp, baseline, f, cx, cy, flow=flow)


def load_flo(data: bytes) -> np.ndarray:
    """Middlebury .flo decode (utils.py load_flow)."""
    assert data[:4] == b"PIEH"
    w = int(np.frombuffer(data, np.int32, 1, 4)[0])
    h = int(np.frombuffer(data, np.int32, 1, 8)[0])
    flow = np.frombuffer(data, np.float32, h * w * 2, 12)
    return flow.reshape(h, w, 2).copy()


def preprocess_ft3d_sample(disp1: np.ndarray, disp1_change: np.ndarray,
                           flow_2d: np.ndarray, max_depth: float = 35.0):
    """One sample -> (pc1 [N,3], flow_3d [N,3], flow_2d_masked, flow_mask).

    Parity with preprocess.py:105-161 (remove_occluded_points=False path,
    minus the per-point occlusion bookkeeping): dense pc1/flow_3d filtered
    by max_depth and NaNs; 2D flow clamped at 500 px.
    """
    pc1 = disp2pc(disp1)
    flow_3d = disp2pc(disp1 + disp1_change, flow=flow_2d) - pc1

    mask1 = pc1[..., -1] < max_depth
    pc1_pts = pc1[mask1]
    flow3d_pts = flow_3d[mask1]
    ok = ~np.isnan(pc1_pts.sum(-1) + flow3d_pts.sum(-1))
    pc1_pts, flow3d_pts = pc1_pts[ok], flow3d_pts[ok]

    flow_mask = (np.abs(flow_2d[..., 0]) < MAX_FLOW_PX) & \
        (np.abs(flow_2d[..., 1]) < MAX_FLOW_PX)
    flow_2d = flow_2d.copy()
    flow_2d[~flow_mask] = 0.0
    return pc1_pts, flow3d_pts, flow_2d, flow_mask


def process_index(input_dir: str, output_dir: str, split: str, index: int,
                  max_depth: float = 35.0) -> None:
    """Disk-to-disk port of Preprocessor.__getitem__ (preprocess.py:75-161)."""
    def rd_pfm(sub):
        with open(os.path.join(input_dir, split, sub), "rb") as f:
            return -read_pfm(f.read())

    disp1 = rd_pfm(f"disparity/left/{index:07d}.pfm")
    disp1_change = rd_pfm(
        f"disparity_change/left/into_future/{index:07d}.pfm")
    with open(os.path.join(input_dir, split, "flow", "left", "into_future",
                           f"{index:07d}.flo"), "rb") as f:
        flow_2d = load_flo(f.read())

    pc1, flow_3d_dense, flow_2d_m, flow_mask = preprocess_ft3d_sample(
        disp1, disp1_change, flow_2d, max_depth)

    for sub in ("pc", "flow_2d", "flow_3d"):
        os.makedirs(os.path.join(output_dir, split, sub), exist_ok=True)
    np.savez(os.path.join(output_dir, split, "pc", f"{index:07d}.npz"),
             pc1=pc1)
    save_flow_png_ft3d(
        os.path.join(output_dir, split, "flow_2d", f"{index:07d}.png"),
        flow_2d_m, flow_mask)
    np.save(os.path.join(output_dir, split, "flow_3d", f"{index:07d}.npy"),
            flow_3d_dense)


def main(argv=None):
    """Batch driver (reference dataset_preprocess/flying_things_3D/
    preprocess.py:58-90): discovers sample indices from
    <input_dir>/<split>/flow/left/into_future/*.flo, writes pc/flow_2d/
    flow_3d per index and a split filename list.

    python -m stablemtl_tpu_torch.preprocess.flyingthings3d \\
        --input_dir <raw> --output_dir <out> --split train
    """
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--input_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--split", default="train")
    ap.add_argument("--max_depth", type=float, default=35.0)
    ap.add_argument("--process_id", type=int, default=0)
    ap.add_argument("--n_processes", type=int, default=1)
    args = ap.parse_args(argv)

    flow_dir = os.path.join(args.input_dir, args.split, "flow", "left",
                            "into_future")
    indices = sorted(int(f.split(".")[0]) for f in os.listdir(flow_dir)
                     if f.endswith(".flo"))
    indices = indices[args.process_id::args.n_processes]
    lines = []
    for index in indices:
        process_index(args.input_dir, args.output_dir, args.split, index,
                      max_depth=args.max_depth)
        lines.append(f"{args.split}/flow_2d/{index:07d}.png")
        print(f"processed {args.split}/{index:07d}", flush=True)
    list_path = os.path.join(args.output_dir, f"{args.split}.txt")
    if args.n_processes > 1:
        # shards must not overwrite each other's list; concatenate the
        # parts when all shards are done
        list_path += f".part{args.process_id:02d}of{args.n_processes:02d}"
    with open(list_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {list_path} ({len(lines)} samples)")


if __name__ == "__main__":
    main()
