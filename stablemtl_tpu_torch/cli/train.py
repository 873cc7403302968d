"""Training CLI, counterpart of `stablemtl_tpu/cli/train.py`.

    python -m stablemtl_tpu_torch.cli.train \\
        --config config/train_stablemtl.yaml \\
        --base_data_dir $BASE_DATA_DIR --output_dir output/run1 \\
        [--device cuda]

Auto-resumes when `<output_dir>/checkpoint/latest` exists (--no_resume
starts over). Runs on --device, the card by default; the CPU only when
asked (`--device cpu`, the plain versions of the kernels).

Data parallelism over N processes, one card each, through the env
contract of `parallel/distributed.py` (STABLEMTL_COORDINATOR,
STABLEMTL_NUM_PROCESSES, STABLEMTL_PROCESS_ID) or torchrun:

    torchrun --nproc_per_node 8 -m stablemtl_tpu_torch.cli.train \
        --config ... --output_dir ...

NCCL on the card, gloo on the CPU. The config's `parallel: {model: M,
zero1: bool}` lays the processes out as a (data x model) mesh, data =
processes / M: the effective batch is split over the data ranks
(`accumulation_steps_of` with the data size), each data rank loads its
shard (model peers the same rows), the main UNet's transformer
projections are split over the M model ranks (tensor parallelism,
parallel/tensor_parallel.py), and the step runs with ZeRO-1
optimizer-state sharding over the data axis unless `zero1: false`.
Process 0 alone writes the resolved config, the code snapshot,
TensorBoard and the vis images.
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
    from ..parallel import MeshConfig, make_mesh
    from ..parallel.distributed import (loader_shard, local_rank,
                                        maybe_initialize, shutdown)
    from ..parallel.sharded_train import (check_replicated,
                                          create_sharded_train_state,
                                          make_sharded_train_step)
    from ..train_state import create_train_state
    from ..trainer import StableMTLTrainer, TrainerConfig
    from ..utils.compilation_cache import enable_persistent_cache
    from ..utils.logging_util import TensorBoardWriter, setup_logging

    enable_persistent_cache()
    cfg = recursive_load_config(
        args.config, root=os.path.dirname(os.path.dirname(
            os.path.abspath(args.config))))
    pcfg = cfg.get("parallel") or {}
    model_axis = int(pcfg.get("model", 1))
    device = resolve_device(args.device)
    # the process group before any heavy build (env-gated; nothing set =
    # one process, no group)
    opened = not torch.distributed.is_initialized()
    distributed = maybe_initialize(device=device)
    opened = opened and distributed
    if distributed and device.type == "cuda":
        device = torch.device("cuda", local_rank())
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 1
    if not distributed and n_cards > 1:
        # one process would train on one of them: not what was asked
        raise RuntimeError(
            f"{n_cards} CUDA devices are visible and no process group is "
            f"open: run one process a card (torchrun --nproc_per_node "
            f"{n_cards} -m stablemtl_tpu_torch.cli.train ..., or "
            f"STABLEMTL_COORDINATOR, STABLEMTL_NUM_PROCESSES and "
            f"STABLEMTL_PROCESS_ID), or pick one card with "
            f"CUDA_VISIBLE_DEVICES")
    mesh = make_mesh(MeshConfig(model=model_axis))
    main_proc = mesh.is_main
    os.makedirs(args.output_dir, exist_ok=True)
    log_name = (cfg.get("logging") or {}).get("filename", "logging.log")
    setup_logging(os.path.join(args.output_dir, log_name if main_proc
                               else f"{log_name}.rank{mesh.process_rank}"))
    log = logging.getLogger("train")

    # the resolved config and a snapshot of the code beside the run: rank
    # 0 only
    if main_proc:
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
    accum, per_step = accumulation_steps_of(cfg, mesh.data)
    log.info("device=%s rank %d of %d accumulation=%d per_step_batch=%d "
             "(global)", device, mesh.process_rank, mesh.world, accum,
             per_step)

    pipeline = build_pipeline(cfg, seed=seed, device=device, trainable=True)
    opt_cfg = build_optimizer_config(cfg, accum)
    if args.no_lr_scheduler:
        opt_cfg = dataclasses.replace(opt_cfg, use_schedule=False)
    train_step_fn = None
    if not distributed:
        state = create_train_state(pipeline.unet, opt_cfg)
    else:
        zero1 = bool(pcfg.get("zero1", True))
        tp = mesh.model > 1
        log.info("mesh %dx%d (data x model) tp=%s zero1=%s", mesh.data,
                 mesh.model, tp, zero1)
        if not tp:
            log.info("data parallel over %d ranks, zero1=%s", mesh.data,
                     zero1)
        state = create_sharded_train_state(pipeline.unet, opt_cfg, mesh,
                                           zero1=zero1)
        train_step_fn = make_sharded_train_step(
            pipeline, mesh, base_seed=seed, zero1=zero1,
            compute_grad_stats=bool((cfg.get("trainer") or {}).get(
                "log_grad_norm", False)))

    loader = build_train_loader(cfg, args.base_data_dir, accum, per_step,
                                seed=int(cfg["dataloader"].get("seed", seed)),
                                num_workers=args.num_workers,
                                shard=loader_shard(mesh))
    val_datasets = build_val_datasets(cfg, args.base_data_dir, "val")
    # vis runs the model on data rank 0 (its model group under tensor
    # parallelism); process 0 alone writes the PNGs
    vis_datasets = (build_val_datasets(cfg, args.base_data_dir, "vis")
                    if mesh.rank == 0 else [])

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
    ckpt = CheckpointManager(os.path.join(args.output_dir, "checkpoint"),
                             mesh=mesh if distributed else None,
                             schedule={"micro_batch": per_step,
                                       "accumulation_steps": accum,
                                       "model": mesh.model})
    writer = (TensorBoardWriter(os.path.join(args.output_dir, "tensorboard"))
              if main_proc else None)
    trainer = StableMTLTrainer(
        pipeline, state, loader, tcfg, ckpt=ckpt,
        val_datasets=val_datasets, vis_datasets=vis_datasets,
        metric_writer=writer, class_colors=class_colors(),
        train_step_fn=train_step_fn, mesh=mesh if distributed else None)
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
    if writer is not None:
        writer.close()
    if distributed:
        # the ranks must end with the same parameters (tensor-parallel
        # shards: across the data axis)
        st = trainer.state
        digest = check_replicated(mesh, list(st.params.values()),
                                  st.split())
        log.info("parameters equal on all %d ranks, digest %s", mesh.world,
                 digest)
    log.info("training done at step %d", int(trainer.state.step))
    if opened:
        shutdown()
    return trainer


if __name__ == "__main__":
    main()
