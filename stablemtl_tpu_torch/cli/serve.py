"""Serving CLI: images through the micro-batched all-task session,
counterpart of `stablemtl_tpu/cli/serve.py`.

    python -m stablemtl_tpu_torch.cli.serve --config cfg.yaml \\
        --images a.png b.png --output_dir out --res 512 --batch 8 \\
        [--save_npz] [--device cuda]

`--config` is a YAML config or a training run directory holding
`config_resolved.json` (which needs no PyYAML). Every image is brought to
--res x --res (a session serves one geometry), run through the fused
all-task step, and each task's prediction is written as
`<stem>_<task>.png` (visualization), plus `<stem>.npz` (task-space
outputs) with --save_npz. The last line of stdout is a JSON summary.
PNG inputs of 8-bit RGB/RGBA are read and the outputs written with the
standard library; other inputs, and resizing to --res, need OpenCV.
The pipeline runs on --device (default cuda; the CPU only when asked).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def read_image(path: str) -> np.ndarray:
    """An image file -> uint8 RGB [H, W, 3]."""
    from ..utils import png

    if path.lower().endswith(".png"):
        try:
            return png.read_png(path)
        except png.UnsupportedPNG:
            pass  # another PNG variant: OpenCV reads it
    try:
        import cv2
    except ImportError as e:
        raise SystemExit(f"{path}: only 8-bit RGB/RGBA PNG is read without "
                         f"OpenCV (cv2)") from e
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise SystemExit(f"could not read image: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Serve StableMTL (PyTorch)")
    parser.add_argument("--config", required=True,
                        help="yaml config or a training output dir")
    parser.add_argument("--checkpoint", default=None,
                        help="checkpoint dir (with `latest`); a run "
                             "directory given as --config implies its own")
    parser.add_argument("--images", nargs="*", default=[],
                        help="input image files (uint8)")
    parser.add_argument("--output_dir", default="output/serve")
    parser.add_argument("--res", type=int, default=512,
                        help="serving resolution (one geometry a session)")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--max_delay_ms", type=float, default=5.0)
    parser.add_argument("--save_npz", action="store_true",
                        help="also save raw task-space outputs per image")
    parser.add_argument("--export", default=None, metavar="PATH",
                        help="the serving artifact (not ported yet: "
                             "ROADMAP A14)")
    parser.add_argument("--pair", action="store_true",
                        help="the two-frame (rgb, rgb_next) entry of "
                             "--export (not ported yet: ROADMAP A14)")
    parser.add_argument("--seed", type=int, default=2024)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "plain versions of the kernels)")
    args = parser.parse_args(argv)

    from .. import TASKS
    from ..config import resolve_config_arg
    from ..evaluation import postprocess_prediction
    from ..factory import build_pipeline, class_colors
    from ..predict import _to_norm, _visualize
    from ..serving import ServingSession, export_pipeline
    from ..utils.image_util import resize
    from ..utils.png import write_png

    cfg, implied_ckpt = resolve_config_arg(args.config)
    if args.checkpoint is None:
        args.checkpoint = implied_ckpt
    if args.export or args.pair:
        export_pipeline()  # raises NotImplementedError (ROADMAP A14)
    if not args.images:
        raise SystemExit("no --images given")

    res_hw = (args.res, args.res)
    pipeline = build_pipeline(cfg, seed=args.seed, device=args.device,
                              image_hw=res_hw)
    if args.checkpoint:
        from ..checkpoint import restore_params

        # the trained weights, rounded to the inference dtype in place
        step, _ = restore_params(args.checkpoint,
                                 dict(pipeline.unet.named_parameters()))
        print(f"# restored checkpoint params at step {step}")
    os.makedirs(args.output_dir, exist_ok=True)
    colors = class_colors()

    def load(path):
        img = read_image(path)
        if img.shape[:2] != res_hw:
            img = resize(img, res_hw, "area")
        return _to_norm(img)

    # read ALL images before submitting: reading inline would space the
    # submits further apart than max_delay_ms, and every image would run as
    # its own padded batch
    loaded = [(p, load(p)) for p in args.images]
    with ServingSession(pipeline, batch=args.batch,
                        max_delay_s=args.max_delay_ms / 1000.0) as sess:
        futures = [(p, sess.submit(img)) for p, img in loaded]
        for path, fut in futures:
            out = fut.result()  # [n_tasks, res, res, 3]
            stem = os.path.splitext(os.path.basename(path))[0]
            raw = {}
            for ti, task in enumerate(TASKS):
                pred = postprocess_prediction(task, out[ti], colors)
                raw[task] = pred
                write_png(os.path.join(args.output_dir, f"{stem}_{task}.png"),
                          _visualize(task, pred, colors))
            if args.save_npz:
                np.savez(os.path.join(args.output_dir, f"{stem}.npz"), **raw)
            print(f"# {path} -> {args.output_dir}/{stem}_<task>.png")
    print(json.dumps({"served": len(futures), "tasks": len(TASKS),
                      "output_dir": args.output_dir}))


if __name__ == "__main__":
    main()
