"""Checkpoint save/restore with the reference's resume contract.
Counterpart of `stablemtl_tpu/checkpoint.py`, in `torch.save` files instead
of orbax.

A checkpoint directory holds named slots:
- `latest`, replaced on every periodic save;
- `iter_XXXXXX` backups named by the EFFECTIVE iteration, never replaced;
- `best`, the parameters at the best main validation metric;
each with a JSON meta file beside it (`<slot>.meta.json`: effective_iter,
loss_ema, best_metric, in_evaluation, interrupted, finished).

A slot is a directory of three files:
- `params.pt`: the trainable parameters by name, f32 as trained;
- `opt_state.pt`: the optimizer's name (`optimizer`), its per-leaf state
  by name in the dtype it is kept in (Adam's `mu`, in `mu_dtype` when one
  is set, and `nu`; Adafactor's factored `v_row` and `v_col` and the
  unfactored `v`, each holding only the leaves that have it), `count`, the
  accumulation state (`mini_step` and the running mean of the gradients,
  `acc`) and apply_if_finite's counters (`notfinite_count`,
  `last_finite`, `total_notfinite`), so a run saved in the middle of an
  accumulation resumes bit-equal. A slot without `optimizer` or the
  counters (written before they were saved) restores as Adam with the
  counters at their start;
- `state.json`: the micro-step counter and, when the manager was given
  one, the schedule it counts in (`micro_batch`, the global rows of a
  micro-step, and `accumulation_steps`) and the size of the mesh's model
  axis (`model`).
Parameters and optimizer state are separate files, so `restore_params`
(eval and serving) reads only the parameters. A slot is written into a
temporary directory first; an existing slot is swapped out with
`os.replace` and deleted only after the new one is in place, and a slot
left renamed by a crash in between is renamed back on the next access.
The data schedule and all randomness replay from the step counter, so
nothing else is saved.

One layout for every world size. Under data parallelism (`mesh`), a
ZeRO-1 optimizer keeps slices of its state: a save gathers them to rank
0's host a 256 MB bucket at a time (no whole moment sits on the card),
rank 0 alone writes, and every rank waits at a barrier after the swap; a
restore memory-maps the files on every rank and copies each rank's slice.
So a checkpoint of N ranks resumes on M, and `cli.eval` and `cli.serve
--checkpoint` read it as any other. Tensor parallelism (a state with a
`layout`) keeps the same files: a save gathers each split parameter and
its state over the model group into the whole leaf (GEGLU's value and
gate halves back in place), and a restore cuts each rank's shard out of
it. So a checkpoint of model 2 restores in one process and the other way
round; the recorded `model` is not held against the run's, since the
numbers do not depend on it. The step counts micro-steps, whose
size the world size sets (`factory.accumulation_steps_of`): a resume
raises unless the run's micro-batch and accumulation are the saved ones,
since the same step would then stand for other samples and another
position in the accumulation (M ranks take the saved global micro-batch
when `dataloader.max_train_batch_size` caps each rank at its share).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .train_state import TrainState

log = logging.getLogger(__name__)

LATEST = "latest"
PARAMS_FILE = "params.pt"
OPT_FILE = "opt_state.pt"
STATE_FILE = "state.json"


# recorded beside the step but not held against a resume: the numbers
# do not depend on it
UNCHECKED = ("model",)

# the optimizer's scalar state and its value at the start of a run
COUNTERS = {"count": 0, "mini_step": 0, "notfinite_count": 0,
            "last_finite": True, "total_notfinite": 0}


def _by_name(names, tensors) -> Dict[str, torch.Tensor]:
    """{name: tensor} of a per-leaf list, without the leaves it has not."""
    return {n: t for n, t in zip(names, tensors) if t is not None}


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


class CheckpointManager:
    """mesh (`parallel.mesh.Mesh`, or None for one process): the ranks
    that save and restore together; rank 0 writes. schedule
    ({"micro_batch": global rows a micro-step, "accumulation_steps": n},
    or None): what the run's step counts, written beside it on save and
    held against a slot's on restore."""

    def __init__(self, ckpt_dir: str, mesh=None,
                 schedule: Optional[dict] = None):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.mesh = mesh
        self.schedule = dict(schedule or {})
        self.is_main = mesh is None or mesh.is_main
        os.makedirs(self.ckpt_dir, exist_ok=True)
        # (slot, bytes, seconds) of every save and restore, in order
        self.saves: list = []
        self.restores: list = []
        if mesh is not None:
            # rank 0 repairs an interrupted swap before anyone reads
            for name in os.listdir(self.ckpt_dir):
                if name.endswith(".old"):
                    self._path(name[:-len(".old")])
            mesh.barrier()

    def _path(self, name: str) -> str:
        path = os.path.join(self.ckpt_dir, name)
        old = path + ".old"
        if (self.is_main and not os.path.isdir(path)
                and os.path.isdir(old)):
            # a crash between the two renames of a swap: the old slot is
            # whole, the new one was never moved in
            os.replace(old, path)
        return path

    # -- save ------------------------------------------------------------

    def save(self, state: TrainState, meta: Optional[dict] = None,
             name: str = LATEST, overwrite: bool = True) -> str:
        """Save the trainable parameters, the optimizer state and the step
        into slot `name`, plus its JSON meta. Raises before writing when
        the disk has less free space than the slot needs."""
        t0 = time.perf_counter()
        path = self._path(name)
        if os.path.exists(path) and not overwrite:
            raise FileExistsError(f"checkpoint slot {path} exists")
        params = self._gather_params(state)
        opt = state.opt
        opt_state = None
        if opt is not None:
            opt_state = self._gather_opt_state(opt, list(params))
        # every rank learns whether rank 0 has the room, so all raise alike
        problem = None
        if self.is_main:
            need = _nbytes(params.values()) + sum(
                _nbytes(d.values()) for d in (opt_state or {}).values()
                if isinstance(d, dict))
            free = shutil.disk_usage(self.ckpt_dir).free
            if free < need:
                problem = (f"checkpoint slot {name} needs {need} bytes, "
                           f"{self.ckpt_dir} has {free} free")
        if self.mesh is not None:
            problem = self.mesh.broadcast_object(problem)
        if problem:
            raise OSError(problem)
        if self.is_main:
            self._write(path, params, opt_state, int(state.step), meta, name)
        if self.mesh is not None:
            self.mesh.barrier()
        nbytes = _dir_bytes(path)
        secs = time.perf_counter() - t0
        self.saves.append((name, nbytes, secs))
        log.info("saved checkpoint %s at step %d: %d bytes in %.2f s", name,
                 int(state.step), nbytes, secs)
        return path

    def _gather_params(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """The parameters by name, each whole: tensor-parallel shards
        gathered over the model group (a collective every rank joins) and
        kept on rank 0's host; others' dict holds only the whole ones."""
        layout = state.layout
        params = {}
        for k, p in state.params.items():
            p = p.detach()
            if layout is None or not layout.sharded(k):
                params[k] = p
                continue
            w = layout.whole(k, p)
            if self.is_main:
                params[k] = w.cpu()
        return params

    def _gather_opt_state(self, opt, names) -> Optional[dict]:
        """The optimizer's state by name, each leaf whole: ZeRO-1 slices
        gathered a bucket at a time (collectives every rank joins) and kept
        on rank 0's host; None on the other ranks."""
        def whole(tensors, sliced=True):
            out = {}
            for i, w in (opt.gathered(tensors) if sliced else
                         enumerate(tensors)):
                if self.is_main and w is not None:
                    # a gathered leaf goes to the host at once
                    out[names[i]] = w if w is tensors[i] else w.cpu()
            return out

        state = {key: whole(tensors, key in opt.PARAM_SHAPED)
                 for key, tensors in opt.moments().items()}
        state["acc"] = None if opt.acc is None else whole(opt.acc)
        if not self.is_main:
            return None
        state.update({key: getattr(opt, key) for key in COUNTERS},
                     optimizer=opt.cfg.optimizer)
        return state

    def _write(self, path, params, opt_state, step, meta, name) -> None:
        tmp = path + ".tmp_swap"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(params, os.path.join(tmp, PARAMS_FILE))
        if opt_state is not None:
            torch.save(opt_state, os.path.join(tmp, OPT_FILE))
        with open(os.path.join(tmp, STATE_FILE), "w") as f:
            json.dump(dict(step=step, **self.schedule), f)
        if os.path.exists(path):
            old = path + ".old"
            shutil.rmtree(old, ignore_errors=True)
            os.replace(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old)
        else:
            os.replace(tmp, path)
        if meta is not None:
            self.write_meta(meta, name)

    def save_backup(self, state: TrainState, meta: Optional[dict] = None,
                    step: Optional[int] = None) -> str:
        """Immutable iter_XXXXXX backup; `step` names it (the trainer
        passes the EFFECTIVE iteration), by default the micro-step."""
        s = int(state.step) if step is None else int(step)
        return self.save(state, meta, name=f"iter_{s:06d}", overwrite=False)

    def write_meta(self, meta: dict, name: str = LATEST) -> None:
        """Rank 0 writes; the others pass."""
        if not self.is_main:
            return
        path = os.path.join(self.ckpt_dir, f"{name}.meta.json")
        with open(path + ".tmp", "w") as f:
            json.dump(_jsonable(meta), f, indent=2)
        os.replace(path + ".tmp", path)

    # -- restore ---------------------------------------------------------

    def exists(self, name: str = LATEST) -> bool:
        return os.path.isdir(self._path(name))

    def restore(self, state: TrainState, name: str = LATEST) -> TrainState:
        """Restore parameters, optimizer state and step into `state`, in
        place (the parameters stay the module's own tensors)."""
        t0 = time.perf_counter()
        path = self._path(name)
        self._check_schedule(path)
        step, _ = restore_params(self.ckpt_dir, state.params, name,
                                 layout=state.layout)
        opt = state.opt
        raw = _load(os.path.join(path, OPT_FILE))
        names = list(state.params)
        saved = raw.get("optimizer", "adam")
        moments = opt.moments()
        if any(key not in raw for key in moments):
            raise ValueError(f"checkpoint {path} holds {saved} state; the "
                             f"optimizer is {opt.cfg.optimizer}")

        def mine(src, sliced=True):
            # this optimizer's part of each whole saved leaf
            return {n: opt.local(i, src[n]) if sliced else src[n]
                    for i, n in enumerate(names) if n in src}

        with torch.no_grad():
            for key, tensors in moments.items():
                _copy_into(_by_name(names, tensors),
                           mine(raw[key], key in opt.PARAM_SHAPED), key,
                           same_dtype=True)
            if (raw["acc"] is None) != (opt.acc is None):
                raise ValueError(
                    f"checkpoint {path} was saved with"
                    f"{'out' if raw['acc'] is None else ''} gradient "
                    f"accumulation; the optimizer has"
                    f"{'out' if opt.acc is None else ''} it")
            if opt.acc is not None:
                _copy_into(dict(zip(names, opt.acc)), mine(raw["acc"]),
                           "acc")
        for key, start in COUNTERS.items():
            setattr(opt, key, type(start)(raw.get(key, start)))
        state.step = step
        self.restores.append((name, _dir_bytes(path),
                              time.perf_counter() - t0))
        return state

    def _check_schedule(self, path: str) -> None:
        """Raise unless the slot's step counts micro-steps of this run's
        size and accumulation (a slot that recorded none passes)."""
        with open(os.path.join(path, STATE_FILE)) as f:
            saved = json.load(f)
        differ = {k: (saved[k], v) for k, v in self.schedule.items()
                  if k in saved and saved[k] != v and k not in UNCHECKED}
        if differ:
            raise ValueError(
                f"checkpoint {path} counts its step {saved['step']} in "
                f"micro-steps of another schedule (saved, this run's): "
                f"{differ}; resume with the saved global micro-batch and "
                f"accumulation (dataloader.max_train_batch_size caps each "
                f"rank's rows)")

    def restore_params_only(self, state: TrainState,
                            name: str = LATEST) -> TrainState:
        """Restore step and parameters, not the optimizer state (eval)."""
        t0 = time.perf_counter()
        state.step, _ = restore_params(self.ckpt_dir, state.params, name,
                                       layout=state.layout)
        path = os.path.join(self._path(name), PARAMS_FILE)
        self.restores.append((name, os.path.getsize(path),
                              time.perf_counter() - t0))
        return state

    def load_meta(self, name: str = LATEST) -> dict:
        p = os.path.join(self.ckpt_dir, f"{name}.meta.json")
        if not os.path.exists(p):
            return {}
        with open(p) as f:
            return json.load(f)


def restore_params(ckpt_dir: str, params: Mapping[str, torch.Tensor],
                   name: str = LATEST, layout=None):
    """Read slot `name`'s step and parameters into the tensors of `params`
    ({name: tensor}, e.g. a module's `named_parameters()`) in place: each
    keeps its device and dtype (a bf16 inference weight takes the stored
    f32 value rounded). `layout` (a `tensor_parallel.TPLayout`): split
    parameters take this rank's shard of the stored whole leaf. The
    optimizer state is not read. Returns (step, params)."""
    path = os.path.join(os.path.abspath(ckpt_dir), name)
    with open(os.path.join(path, STATE_FILE)) as f:
        step = int(json.load(f)["step"])
    raw = _load(os.path.join(path, PARAMS_FILE))
    if layout is not None:
        raw = {k: layout.local(k, v) for k, v in raw.items()}
    with torch.no_grad():
        _copy_into(params, raw, "params")
    return step, params


def _load(path: str):
    # memory-mapped: each tensor is read once, into its destination
    return torch.load(path, map_location="cpu", mmap=True, weights_only=True)


def _copy_into(dst: Mapping[str, torch.Tensor],
               src: Dict[str, torch.Tensor], what: str,
               same_dtype: bool = False) -> None:
    missing = sorted(set(dst) - set(src))
    unexpected = sorted(set(src) - set(dst))
    if missing or unexpected:
        raise ValueError(f"checkpoint {what}: {len(missing)} missing (e.g. "
                         f"{missing[:3]}), {len(unexpected)} unexpected "
                         f"(e.g. {unexpected[:3]})")
    for k, t in dst.items():
        if tuple(src[k].shape) != tuple(t.shape):
            raise ValueError(f"checkpoint {what} {k}: shape "
                             f"{tuple(src[k].shape)} != {tuple(t.shape)}")
        if same_dtype and src[k].dtype != t.dtype:
            raise ValueError(f"checkpoint {what} {k}: dtype {src[k].dtype} "
                             f"!= {t.dtype}")
        t.copy_(src[k])


def _jsonable(obj: Any):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, torch.Tensor):
        return obj.tolist()
    return obj
