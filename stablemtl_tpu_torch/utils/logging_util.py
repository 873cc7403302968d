"""Logging: console+file setup, TensorBoard writer, eval-table dump.
Counterpart of `stablemtl_tpu/utils/logging_util.py`.

TensorBoard events are written through `torch.utils.tensorboard` when the
`tensorboard` package is importable; without it the writer does nothing and
says so once in the log, as the JAX package's writer does without
tensorflow. TensorBoard is switched to its own TensorFlow-free event
writer: the training process never loads TensorFlow. Nothing here touches
the device path.
"""

from __future__ import annotations

import csv
import logging
import os
import sys
import types
from typing import Dict, Optional

import numpy as np

FORMAT = (" %(asctime)s - %(levelname)s -%(filename)s - %(funcName)s "
          ">> %(message)s")

log = logging.getLogger(__name__)


def setup_logging(filename: Optional[str] = None,
                  console_level: int = logging.INFO,
                  file_level: int = logging.INFO) -> None:
    root = logging.getLogger()
    root.setLevel(min(console_level, file_level))
    root.handlers = [h for h in root.handlers
                     if not isinstance(h, (logging.StreamHandler,
                                           logging.FileHandler))]
    sh = logging.StreamHandler()
    sh.setLevel(console_level)
    sh.setFormatter(logging.Formatter(FORMAT))
    root.addHandler(sh)
    if filename:
        os.makedirs(os.path.dirname(os.path.abspath(filename)),
                    exist_ok=True)
        fh = logging.FileHandler(filename)
        fh.setLevel(file_level)
        fh.setFormatter(logging.Formatter(FORMAT))
        root.addHandler(fh)


class TensorBoardWriter:
    """Callable scalar writer: writer(step, {tag: value}); `write_images`
    for uint8 [H, W, 3] panels."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._writer = None
        self._missing = False

    def _ensure(self):
        if self._writer is None and not self._missing:
            # TensorBoard's no-TensorFlow switch (its compat.notf module):
            # where TensorFlow is installed, it would otherwise be imported
            # (~18 s) only to write event files
            sys.modules.setdefault("tensorboard.compat.notf",
                                   types.ModuleType("tensorboard.compat.notf"))
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                self._missing = True
                log.info("tensorboard is not installed: no TensorBoard "
                         "events are written to %s", self.log_dir)
                return None
            os.makedirs(self.log_dir, exist_ok=True)
            self._writer = SummaryWriter(self.log_dir)
        return self._writer

    def __call__(self, step: int, scalars: Dict[str, float]):
        writer = self._ensure()
        if writer is None:
            return
        for tag, val in scalars.items():
            try:
                writer.add_scalar(tag, float(val), global_step=step)
            except (TypeError, ValueError):
                pass
        writer.flush()

    def write_images(self, step: int, images: Dict[str, np.ndarray]):
        writer = self._ensure()
        if writer is None:
            return
        for tag, img in images.items():
            writer.add_image(tag, img, global_step=step, dataformats="HWC")
        writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None


def eval_dict_to_text(results: Dict[str, Dict[str, Dict[str, float]]]) -> str:
    """{dataset: {task: {metric: value}}} -> aligned text table
    (reference eval_dic_to_text, logging_util.py:95-112)."""
    lines = []
    for ds_name, per_task in results.items():
        for task, metrics in per_task.items():
            lines.append(f"== {ds_name} / {task} ==")
            if not metrics:
                lines.append("  (no metrics)")
                continue
            width = max(len(k) for k in metrics)
            for k, v in metrics.items():
                try:
                    lines.append(f"  {k:<{width}} : {float(v):.6f}")
                except (TypeError, ValueError):
                    lines.append(f"  {k:<{width}} : {v}")
    return "\n".join(lines)


def eval_dict_to_csv(results, path: str) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["dataset", "task", "metric", "value"])
        for ds_name, per_task in results.items():
            for task, metrics in per_task.items():
                for k, v in metrics.items():
                    try:
                        w.writerow([ds_name, task, k, float(v)])
                    except (TypeError, ValueError):
                        w.writerow([ds_name, task, k, v])
