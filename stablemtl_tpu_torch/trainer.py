"""Training orchestration: loop, logging, checkpoint cadence, validation.
Counterpart of `stablemtl_tpu/trainer.py`, around the port's eager
training step (train_state.make_train_step).

- The loader yields numpy batches; the trainer moves each to the device
  itself, from pinned host memory with non-blocking copies.
- Step metrics are read ONE STEP LATE: `float(loss)` waits for the card, so
  micro-step N's scalars are read after micro-step N+1 is dispatched. A
  checkpoint save waits for the card anyway, so the pending scalars are
  read before it and the saved loss EMA includes the saved step.
- Resume state is the step counter, the parameters and the optimizer state
  (checkpoint.py); the data schedule and all randomness replay from the
  step counter.
- `exit_after` minutes: a checkpoint and a graceful stop, possibly in the
  middle of a gradient accumulation.
- Data parallelism (`mesh`, with the data-parallel step as
  `train_step_fn`): every rank runs the loop on its shard of each batch
  and logs the global loss. The ranks of data index 0 alone validate and
  visualize (the parameters are equal on every data rank): one process,
  or under tensor parallelism the model group of data rank 0, which runs
  the eval forward on its shards together. Process 0 sends the results
  to the others, which wait for them; it alone writes metrics and vis
  images. Saves are collective (checkpoint.py). Process 0 alone reads
  the clock for `exit_after` and sends its decision every micro-step: the
  JAX trainer reads each process's own clock, so its ranks can stop at
  different steps and hang in the next collective.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from . import TASKS
from .checkpoint import CheckpointManager
from .evaluation import Evaluator, make_task_metrics
from .pipeline import StableMTLPipeline
from .train_state import (TrainState, make_eval_step, make_eval_tasks_step,
                          make_train_step)

log = logging.getLogger(__name__)

# the loader batch's arrays the training step reads
STEP_KEYS = ("rgb_norm", "rgb_next_norm", "target_3ch", "valid_mask")


@dataclasses.dataclass
class TrainerConfig:
    max_iter: int = 20_000                 # effective iterations
    gradient_accumulation_steps: int = 1
    save_period: int = 500
    backup_period: int = 1000
    validation_period: int = 1000
    visualization_period: int = 2000
    log_period: int = 50
    loss_ema: float = 0.98                 # per-task EMA smoothing
    log_grad_norm: bool = False            # grad-norm mean/std scalars
    exit_after_minutes: float = -1.0
    base_seed: int = 0
    output_dir: str = ""
    # model selection: a "dataset/task/metric" path into validate()'s
    # results ("" = first dataset / first task / first metric); a `best`
    # checkpoint is kept at its best value
    main_val_metric: str = ""
    main_val_metric_goal: str = "minimize"  # or "maximize"
    # device batch of eval inference (metrics stay per sample on the host)
    eval_batch_size: int = 4


class StableMTLTrainer:
    def __init__(self, pipeline: StableMTLPipeline, state: TrainState,
                 loader, config: TrainerConfig,
                 ckpt: Optional[CheckpointManager] = None,
                 val_datasets: Sequence = (),
                 metric_writer: Optional[Callable[[int, Dict], None]] = None,
                 class_colors: Optional[np.ndarray] = None,
                 vis_datasets: Sequence = (),
                 train_step_fn: Optional[Callable] = None, mesh=None):
        self.pipeline = pipeline
        self.state = state
        self.loader = loader
        self.cfg = config
        self.ckpt = ckpt
        self.val_datasets = list(val_datasets)
        # dedicated visualization subsets; the val sets without them
        self.vis_datasets = list(vis_datasets) or self.val_datasets
        self.metric_writer = metric_writer
        self.class_colors = class_colors
        self.device = pipeline.device
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        # the ranks that run validation and visualization: data rank 0
        self.evaluates = mesh is None or mesh.rank == 0
        self.train_step = train_step_fn or (make_train_step(
            pipeline, base_seed=config.base_seed,
            compute_grad_stats=config.log_grad_norm)
            if state.opt is not None else None)
        self._eval_step = None
        self._eval_tasks_step = None
        self.loss_ema: Dict[str, float] = {}
        self.best_metric: Optional[float] = None
        # (micro-step, task, (H, W), host seconds of its loop iteration)
        self.step_times: list = []
        # (micro-step, task, loss), read one step late
        self.losses: list = []
        # the micro-step whose parameters `latest` holds
        self.saved_step: Optional[int] = None

    # -- device batches --------------------------------------------------

    def to_device(self, arr) -> torch.Tensor:
        """numpy -> a tensor on the pipeline's device; through pinned host
        memory and a non-blocking copy on the card."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # -- resume ----------------------------------------------------------

    def maybe_resume(self) -> int:
        if self.ckpt is not None and self.ckpt.exists():
            self.state = self.ckpt.restore(self.state)
            self.saved_step = int(self.state.step)
            meta = self.ckpt.load_meta()
            self.best_metric = meta.get("best_metric")
            # continue the logged loss curves
            self.loss_ema = dict(meta.get("loss_ema") or {})
            log.info("resumed from checkpoint at step %d",
                     int(self.state.step))
            # a checkpoint saved mid-validation: redo the validation, use
            # its results, and clear the flag
            if meta.get("in_evaluation") and self.val_datasets:
                log.info("checkpoint was saved mid-validation; re-running")
                eff = self.effective_iter
                results = self._validate_on_main()
                self._update_best(results, eff)
                self.ckpt.write_meta({"effective_iter": eff,
                                      "in_evaluation": False,
                                      "loss_ema": self.loss_ema,
                                      "best_metric": self.best_metric})
                self._write_val_metrics(int(self.state.step), results)
        return int(self.state.step)

    def _write_val_metrics(self, step: int, results: Dict) -> None:
        if self.metric_writer:
            flat = {f"val/{ds}/{t}/{k}": v
                    for ds, per in results.items()
                    for t, r in per.items() for k, v in r.items()}
            self.metric_writer(step, flat)

    def _validate_on_main(self) -> Dict:
        """`validate` on data rank 0, process 0's results on every rank."""
        results = self.validate() if self.evaluates else None
        if self.mesh is not None:
            results = self.mesh.broadcast_object(results)
        return results

    def _stop_now(self, t_start: float) -> bool:
        """Whether exit_after has run out: rank 0's clock decides."""
        stop = ((time.monotonic() - t_start) / 60
                > self.cfg.exit_after_minutes)
        if self.mesh is not None:
            stop = self.mesh.broadcast_object(stop)
        return stop

    def _save(self, meta: dict, name: str = "latest") -> None:
        self.ckpt.save(self.state, meta=meta, name=name)
        if name == "latest":
            self.saved_step = int(self.state.step)

    def save_final(self, meta: dict) -> None:
        """The end-of-run `latest`: the state is written only when `latest`
        does not already hold this step, the meta always."""
        if self.saved_step == int(self.state.step):
            self.ckpt.write_meta(meta)
        else:
            self._save(meta)

    # -- train -----------------------------------------------------------

    @property
    def effective_iter(self) -> int:
        return int(self.state.step) // self.cfg.gradient_accumulation_steps

    def train(self) -> TrainState:
        cfg = self.cfg
        start_step = int(self.state.step)
        max_micro = cfg.max_iter * cfg.gradient_accumulation_steps
        t_start = time.monotonic()
        pending = None  # (step, eff, task, metrics, seconds)

        def consume(p):
            p_step, p_eff, p_task, p_metrics, p_dt = p
            loss = float(p_metrics["loss"])
            self.losses.append((p_step, p_task, loss))
            prev = self.loss_ema.get(p_task, loss)
            self.loss_ema[p_task] = (cfg.loss_ema * prev
                                     + (1 - cfg.loss_ema) * loss)
            if float(p_metrics.get("nan_pred", 0)):
                log.warning("model_pred contains NaN at step %d", p_step)
            if p_step % cfg.log_period == 0 or p_step == max_micro:
                scalars = {"loss": loss,
                           f"loss/{p_task}": self.loss_ema[p_task],
                           "step_time_s": p_dt}
                if "grad_norm_mean" in p_metrics:
                    scalars["grad_norm/mean"] = float(
                        p_metrics["grad_norm_mean"])
                    scalars["grad_norm/std"] = float(
                        p_metrics["grad_norm_std"])
                if self.metric_writer:
                    self.metric_writer(p_step, scalars)
                log.info("step %d (eff %d) task=%s loss=%.5f", p_step, p_eff,
                         p_task, loss)

        def flush():
            nonlocal pending
            if pending is not None:
                consume(pending)
                pending = None

        t_prev = time.monotonic()
        for batch in self.loader.batches(start_step=start_step,
                                         max_steps=max_micro - start_step):
            task = TASKS[int(batch["task_idx"])]
            device_batch = {k: self.to_device(batch[k]) for k in STEP_KEYS}
            device_batch["task_idx"] = int(batch["task_idx"])
            self.state, metrics = self.train_step(self.state, device_batch)
            step = int(batch["step"]) + 1
            eff = step // cfg.gradient_accumulation_steps
            flush()
            now = time.monotonic()
            # the loop iteration's host time: loading, copies, dispatch and
            # the wait for the previous step's scalars
            self.step_times.append(
                (step, task, tuple(batch["rgb_norm"].shape[1:3]),
                 now - t_prev))
            pending = (step, eff, task, metrics, now - t_prev)

            at_effective = step % cfg.gradient_accumulation_steps == 0
            if at_effective and self.ckpt is not None:
                if eff % cfg.save_period == 0:
                    flush()
                    self._save({"effective_iter": eff,
                                "loss_ema": self.loss_ema,
                                "best_metric": self.best_metric})
                if eff % cfg.backup_period == 0:
                    # named by the EFFECTIVE iteration
                    self.ckpt.save_backup(self.state, step=eff)
            if (at_effective and cfg.visualization_period > 0
                    and self.evaluates
                    and self.vis_datasets and cfg.output_dir
                    and eff % cfg.visualization_period == 0):
                self.visualize(os.path.join(cfg.output_dir, "vis",
                                            f"iter_{eff:06d}"))
            if (at_effective and self.val_datasets
                    and eff % cfg.validation_period == 0):
                flush()
                if self.ckpt is not None:
                    self._save({"effective_iter": eff,
                                "in_evaluation": True,
                                "loss_ema": self.loss_ema,
                                "best_metric": self.best_metric})
                results = self._validate_on_main()
                self._update_best(results, eff)
                if self.ckpt is not None:
                    self.ckpt.write_meta({"effective_iter": eff,
                                          "in_evaluation": False,
                                          "loss_ema": self.loss_ema,
                                          "best_metric": self.best_metric})
                self._write_val_metrics(step, results)
            if cfg.exit_after_minutes > 0 and self._stop_now(t_start):
                log.info("exit_after reached; checkpointing and stopping")
                if self.ckpt is not None:
                    flush()
                    self._save({"effective_iter": eff, "interrupted": True,
                                "loss_ema": self.loss_ema,
                                "best_metric": self.best_metric})
                break
            t_prev = time.monotonic()
        flush()
        return self.state

    # -- validation ------------------------------------------------------

    def _evaluator(self) -> Evaluator:
        if self._eval_step is None:
            self._eval_step = make_eval_step(self.pipeline)
            self._eval_tasks_step = make_eval_tasks_step(self.pipeline)

        def maybe(arr):
            return None if arr is None else self.to_device(arr)

        def infer(rgb, rgb_next, task_idx):
            out = self._eval_step({"rgb_norm": self.to_device(rgb),
                                   "rgb_next_norm": maybe(rgb_next),
                                   "task_idx": int(task_idx)})
            return out.float().cpu().numpy()

        def infer_tasks(rgb, rgb_next, task_indices):
            out = self._eval_tasks_step(self.to_device(rgb), maybe(rgb_next),
                                        [int(t) for t in task_indices])
            return out.float().cpu().numpy()

        return Evaluator(infer_fn=infer, infer_tasks_fn=infer_tasks,
                         batch_size=max(1, self.cfg.eval_batch_size),
                         class_colors=self.class_colors)

    def _update_best(self, results: Dict, eff: int) -> None:
        """Track the main val metric; keep a `best` checkpoint when it
        improves."""
        val = _lookup_metric(results, self.cfg.main_val_metric)
        if val is None:
            return
        sign = -1.0 if self.cfg.main_val_metric_goal == "maximize" else 1.0
        if self.best_metric is None or sign * val < sign * self.best_metric:
            prev = self.best_metric
            self.best_metric = float(val)
            log.info("main val metric improved %s -> %.6f at eff iter %d",
                     "none" if prev is None else f"{prev:.6f}", val, eff)
            if self.ckpt is not None:
                self._save({"effective_iter": eff,
                            "best_metric": self.best_metric}, name="best")

    def visualize(self, out_dir: str, max_samples: int = 2) -> None:
        """Side-by-side [input | GT | prediction] panels for a few samples
        of the vis sets, saved as PNG and, when the metric writer takes
        images, to TensorBoard."""
        from .evaluation import postprocess_prediction, visualize_gt
        from .pipeline import TASK_INDEX
        from .predict import _visualize
        from .utils.visualizer import save_image

        ev = self._evaluator()
        images = {}
        for ds in self.vis_datasets:
            tasks = ds.output_type if isinstance(ds.output_type,
                                                 (list, tuple)) \
                else [ds.output_type]
            for i in range(min(max_samples, len(ds))):
                sample = ds.get(i, np.random.default_rng(i))
                rgb_u8 = ((sample["rgb_norm"] + 1) * 127.5) \
                    .clip(0, 255).astype(np.uint8)
                single = sample["rgb_next_norm"] is sample["rgb_norm"]
                for task in tasks:
                    pred3 = ev.infer_fn(
                        sample["rgb_norm"][None],
                        None if single else sample["rgb_next_norm"][None],
                        TASK_INDEX[task])[0]
                    out = postprocess_prediction(task, pred3,
                                                 self.class_colors)
                    panels = [rgb_u8]
                    gt_vis = visualize_gt(task, sample, self.class_colors)
                    if gt_vis is not None:
                        panels.append(gt_vis)
                    panels.append(_visualize(task, out, self.class_colors))
                    panel = np.concatenate(panels, axis=1)
                    images[f"vis/{ds.disp_name}/{task}/{i}"] = panel
                    if self.is_main:
                        save_image(panel, os.path.join(
                            out_dir, f"{ds.disp_name}_{i:03d}_{task}.png"))
        writer_images = getattr(self.metric_writer, "write_images", None)
        if writer_images is not None:
            writer_images(int(self.state.step), images)

    def validate(self, max_samples: Optional[int] = None) -> Dict:
        ev = self._evaluator()
        results = {}
        for ds in self.val_datasets:
            tasks = ds.output_type if isinstance(ds.output_type, (list, tuple)) \
                else [ds.output_type]
            results[ds.disp_name] = ev.evaluate(
                ds, tasks=tasks, max_samples=max_samples,
                metrics=make_task_metrics())
            log.info("val %s: %s", ds.disp_name, results[ds.disp_name])
        return results


def _lookup_metric(results: Dict, spec: str) -> Optional[float]:
    """One scalar of {dataset: {task: {metric: value}}}.

    spec "" = first dataset / first task / first metric; otherwise a
    "dataset/task/metric" path (each segment optional from the left, e.g.
    "abs_relative_difference" or "depth/abs_relative_difference")."""
    if not results:
        return None
    if not spec:
        per_task = next(iter(results.values()))
        if not per_task:
            return None
        metrics = next(iter(per_task.values()))
        return float(next(iter(metrics.values()))) if metrics else None
    parts = spec.split("/")
    metric = parts[-1]
    for ds_name, per_task in results.items():
        if len(parts) >= 3 and ds_name != parts[-3]:
            continue
        for task, metrics in per_task.items():
            if len(parts) >= 2 and task != parts[-2]:
                continue
            if metric in metrics:
                return float(metrics[metric])
    return None
