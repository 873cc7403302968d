"""Training CLI, counterpart of `stablemtl_tpu/cli/train.py`.

    python -m stablemtl_tpu_torch.cli.train \\
        --config config/train_stablemtl.yaml \\
        --base_data_dir $BASE_DATA_DIR --output_dir output/run1 \\
        [--device cuda]

Auto-resumes when `<output_dir>/checkpoint/latest` exists (--no_resume
starts over). Runs on --device, the card by default; the CPU only when
asked (`--device cpu`, the plain versions of the kernels). One device:
more than one, or the config's `parallel.model` > 1, is the data- and
tensor-parallel path, which is not ported (ROADMAP A13).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import tarfile


def main(argv=None):
    """Returns the trainer, whose state holds the final parameters."""
    parser = argparse.ArgumentParser(description="Train StableMTL (PyTorch)")
    parser.add_argument("--config", required=True)
    parser.add_argument("--base_data_dir",
                        default=os.environ.get("BASE_DATA_DIR", "."))
    parser.add_argument("--output_dir", default="output/run")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--exit_after", type=float, default=-1,
                        help="minutes before graceful exit w/ checkpoint")
    parser.add_argument("--no_lr_scheduler", action="store_true")
    parser.add_argument("--max_iter", type=int, default=None)
    parser.add_argument("--no_resume", action="store_true")
    parser.add_argument("--num_workers", type=int, default=None,
                        help="loader worker processes (overrides "
                             "dataloader.num_workers; 0 = in-process)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "plain versions of the kernels)")
    args = parser.parse_args(argv)

    import dataclasses

    import torch

    from ..checkpoint import CheckpointManager
    from ..config import recursive_load_config
    from ..factory import (accumulation_steps_of, build_optimizer_config,
                           build_pipeline, build_train_loader,
                           build_val_datasets, class_colors, resolve_device)
    from ..train_state import create_train_state
    from ..trainer import StableMTLTrainer, TrainerConfig
    from ..utils.logging_util import TensorBoardWriter, setup_logging

    device = resolve_device(args.device)
    cfg = recursive_load_config(
        args.config, root=os.path.dirname(os.path.dirname(
            os.path.abspath(args.config))))
    n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    model_axis = int((cfg.get("parallel") or {}).get("model", 1))
    if n_devices > 1 or model_axis > 1:
        raise NotImplementedError(
            f"{n_devices} devices, parallel.model {model_axis}: training "
            f"across devices is not ported (ROADMAP A13); run on one "
            f"(CUDA_VISIBLE_DEVICES)")
    os.makedirs(args.output_dir, exist_ok=True)
    setup_logging(os.path.join(args.output_dir,
                               (cfg.get("logging") or {}).get(
                                   "filename", "logging.log")))
    log = logging.getLogger("train")

    # the resolved config and a snapshot of the code beside the run
    with open(os.path.join(args.output_dir, "config_resolved.json"),
              "w") as f:
        json.dump(cfg.to_dict(), f, indent=2, default=str)
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    snap = os.path.join(args.output_dir, "code_snapshot.tar.gz")
    if not os.path.exists(snap):
        with tarfile.open(snap, "w:gz") as tar:
            tar.add(pkg_dir, arcname="stablemtl_tpu_torch",
                    filter=lambda ti: None if "__pycache__" in ti.name
                    or "/_build" in ti.name else ti)

    seed = args.seed if args.seed is not None else \
        int((cfg.get("trainer") or {}).get("init_seed", 2024))
    accum, per_step = accumulation_steps_of(cfg, n_devices)
    log.info("device=%s accumulation=%d per_step_batch=%d", device, accum,
             per_step)

    pipeline = build_pipeline(cfg, seed=seed, device=device, trainable=True)
    opt_cfg = build_optimizer_config(cfg, accum)
    if args.no_lr_scheduler:
        opt_cfg = dataclasses.replace(opt_cfg, use_schedule=False)
    state = create_train_state(pipeline.unet, opt_cfg)

    loader = build_train_loader(cfg, args.base_data_dir, accum, per_step,
                                seed=int(cfg["dataloader"].get("seed", seed)),
                                num_workers=args.num_workers)
    val_datasets = build_val_datasets(cfg, args.base_data_dir, "val")
    vis_datasets = build_val_datasets(cfg, args.base_data_dir, "vis")

    tsrc = cfg.get("trainer") or {}
    tcfg = TrainerConfig(
        max_iter=int(args.max_iter or cfg.get("max_iter", 20000)),
        gradient_accumulation_steps=accum,
        save_period=int(tsrc.get("save_period", 500)),
        backup_period=int(tsrc.get("backup_period", 1000)),
        validation_period=int(tsrc.get("validation_period", 1000)),
        visualization_period=int(tsrc.get("visualization_period", 2000)),
        log_period=int(tsrc.get("log_period", 50)),
        log_grad_norm=bool(tsrc.get("log_grad_norm", False)),
        main_val_metric=str(tsrc.get("main_val_metric", "")),
        main_val_metric_goal=str(tsrc.get("main_val_metric_goal",
                                          "minimize")),
        exit_after_minutes=args.exit_after,
        base_seed=seed,
        output_dir=args.output_dir,
    )
    ckpt = CheckpointManager(os.path.join(args.output_dir, "checkpoint"))
    writer = TensorBoardWriter(os.path.join(args.output_dir, "tensorboard"))
    trainer = StableMTLTrainer(
        pipeline, state, loader, tcfg, ckpt=ckpt,
        val_datasets=val_datasets, vis_datasets=vis_datasets,
        metric_writer=writer, class_colors=class_colors())
    if not args.no_resume:
        trainer.maybe_resume()
    trainer.train()
    # the final save only when the run completed: an exit_after stop has
    # already written `latest` with its interrupted meta
    if trainer.effective_iter >= tcfg.max_iter:
        trainer.save_final({"finished": True,
                            "effective_iter": trainer.effective_iter,
                            "loss_ema": trainer.loss_ema,
                            "best_metric": trainer.best_metric})
    writer.close()
    log.info("training done at step %d", int(trainer.state.step))
    return trainer


if __name__ == "__main__":
    main()
