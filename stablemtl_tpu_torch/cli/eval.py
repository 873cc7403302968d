"""Evaluation CLI, counterpart of `stablemtl_tpu/cli/eval.py`.

    python -m stablemtl_tpu_torch.cli.eval --config output/run1 \\
        --base_data_dir $BASE_DATA_DIR --split test \\
        --output_dir output/run1/eval [--device cuda]

`--config` is a YAML config or a training run directory (its
`config_resolved.json`, and its `checkpoint/` unless --checkpoint names
another). Restores the checkpoint's parameters only, runs the per-task
metrics over the split with the trainer's `validate`, and writes
eval_results.json, .txt and .csv. Runs on --device, the card by default.
"""

from __future__ import annotations

import argparse
import json
import logging
import os


def main(argv=None):
    """Returns (results, trainer)."""
    parser = argparse.ArgumentParser(description="Evaluate StableMTL "
                                                 "(PyTorch)")
    parser.add_argument("--config", required=True,
                        help="yaml config or a training output dir")
    parser.add_argument("--checkpoint", default=None,
                        help="checkpoint dir (with `latest`)")
    parser.add_argument("--base_data_dir",
                        default=os.environ.get("BASE_DATA_DIR", "."))
    parser.add_argument("--output_dir", default="output/eval")
    parser.add_argument("--split", default="test", choices=["val", "test"])
    parser.add_argument("--max_samples", type=int, default=None,
                        help="evaluate the first N samples of each set")
    parser.add_argument("--save_predictions", action="store_true",
                        help="save per-sample prediction visualizations")
    parser.add_argument("--seed", type=int, default=2024)
    parser.add_argument("--eval_batch_size", type=int, default=4,
                        help="device batch of eval inference (metrics are "
                             "per sample)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "plain versions of the kernels)")
    args = parser.parse_args(argv)

    from ..checkpoint import CheckpointManager
    from ..config import resolve_config_arg
    from ..factory import build_pipeline, build_val_datasets, class_colors
    from ..train_state import eval_state
    from ..trainer import StableMTLTrainer, TrainerConfig
    from ..utils.logging_util import (eval_dict_to_csv, eval_dict_to_text,
                                      setup_logging)

    cfg, implied_ckpt = resolve_config_arg(args.config)
    if args.checkpoint is None:
        args.checkpoint = implied_ckpt
    os.makedirs(args.output_dir, exist_ok=True)
    setup_logging(os.path.join(args.output_dir, "eval.log"))
    log = logging.getLogger("eval")

    # the main UNet keeps f32 weights, as the trainer holds them: the
    # restore is bit-equal to the trained parameters and the metrics are
    # those of the trainer's own validate
    pipeline = build_pipeline(cfg, seed=args.seed, device=args.device,
                              trainable=True)
    pipeline.unet.requires_grad_(False)
    state = eval_state(pipeline.unet)
    ckpt = None
    if args.checkpoint:
        # parameters only: no optimizer is made, its moments are not read
        ckpt = CheckpointManager(args.checkpoint)
        state = ckpt.restore_params_only(state)
        log.info("restored checkpoint params at step %d", state.step)

    datasets = build_val_datasets(cfg, args.base_data_dir, args.split)
    trainer = StableMTLTrainer(
        pipeline, state, loader=None,
        config=TrainerConfig(eval_batch_size=args.eval_batch_size),
        ckpt=ckpt, val_datasets=datasets, class_colors=class_colors())
    results = trainer.validate(max_samples=args.max_samples)
    if args.save_predictions:
        trainer.visualize(os.path.join(args.output_dir, "predictions"),
                          max_samples=args.max_samples or 8)

    text = eval_dict_to_text(results)
    print(text)
    with open(os.path.join(args.output_dir, "eval_results.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    with open(os.path.join(args.output_dir, "eval_results.txt"), "w") as f:
        f.write(text)
    eval_dict_to_csv(results, os.path.join(args.output_dir,
                                           "eval_results.csv"))
    log.info("wrote results to %s", args.output_dir)
    return results, trainer


if __name__ == "__main__":
    main()
