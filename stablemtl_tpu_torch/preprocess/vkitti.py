"""Virtual KITTI 2 per-task filename-list generation.

Covers reference dataset_preprocess/vkitti/list_filenames.py:1-59: from the
`vkitti_{split}.txt` (rgb, depth) pair list it derives the relative path of
every other task's ground truth with string-rewrite rules and writes one
list file per task, keeping only rows whose file exists on disk. A missing
rgb is a hard error; a missing task file is reported and skipped
(list_filenames.py:33-54).
"""

from __future__ import annotations

import os
from typing import Tuple

# rewrite rules (list_filenames.py:24-30), applied to the "original/"-rooted
# relative paths
_SEM = (("/rgb/", "/classSegmentation/"), ("rgb_", "classgt_"),
        ("jpg", "png"))
_NRM = (("original", "normal_estimated"), ("png", "npy"),
        ("depth", "normal"))
_FLW = (("rgb_", "flow_"), ("rgb", "forwardFlow"), ("jpg", "png"))


def _rewrite(path: str, rules) -> str:
    for old, new in rules:
        path = path.replace(old, new)
    return path


def derive_task_paths(rgb_rel: str, depth_rel: str) -> dict:
    """(rgb, depth) split-row -> per-task relative paths.

    Both inputs are the raw split-file fields; the returned paths are rooted
    at the dataset dir exactly like the reference's (incl. the "original/"
    prefix added to rgb/depth, list_filenames.py:25-27).
    """
    rgb = os.path.join("original", rgb_rel)
    depth = os.path.join("original", depth_rel)
    return {
        "rgb": rgb,
        "depth": depth,
        "semantic": _rewrite(rgb, _SEM),
        "normal": _rewrite(depth, _NRM),
        "optical_flow": _rewrite(rgb, _FLW),
    }


def list_filenames(split_file: str, dataset_dir: str, out_dir: str,
                   split: str) -> dict:
    """Write vkitti_{split}_{task}.txt lists filtered by file existence.

    Returns {task: n_rows_written}. Raises on a missing rgb (the reference
    treats that as corruption of the split itself, list_filenames.py:33-34).
    """
    with open(split_file) as f:
        rows: Tuple[str, ...] = [s.strip().split() for s in f
                                 if s.strip()]

    os.makedirs(out_dir, exist_ok=True)
    tasks = ("semantic", "normal", "depth", "optical_flow")
    counts = {t: 0 for t in tasks}
    handles = {t: open(os.path.join(out_dir, f"vkitti_{split}_{t}.txt"),
                       "w") for t in tasks}
    try:
        for row in rows:
            paths = derive_task_paths(row[0], row[1])
            if not os.path.exists(os.path.join(dataset_dir, paths["rgb"])):
                raise ValueError(
                    f"Not found: {os.path.join(dataset_dir, paths['rgb'])}")
            for t in tasks:
                p = paths[t]
                if os.path.exists(os.path.join(dataset_dir, p)):
                    handles[t].write(p + "\n")
                    counts[t] += 1
                else:
                    print(f"Not found: {os.path.join(dataset_dir, p)}")
    finally:
        for h in handles.values():
            h.close()
    return counts


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--split", default="val")
    ap.add_argument("--split_file", default=None,
                    help="default: data_split/vkitti/vkitti_{split}.txt")
    ap.add_argument("--dataset_dir", required=True)
    ap.add_argument("--out_dir", default=None,
                    help="default: alongside the split file")
    args = ap.parse_args(argv)

    split_file = args.split_file or os.path.join(
        "data_split", "vkitti", f"vkitti_{args.split}.txt")
    out_dir = args.out_dir or os.path.dirname(split_file)
    counts = list_filenames(split_file, args.dataset_dir, out_dir,
                            args.split)
    for t, n in counts.items():
        print(f"vkitti_{args.split}_{t}.txt: {n} rows")


if __name__ == "__main__":
    main()
