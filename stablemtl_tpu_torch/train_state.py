"""Train state, optimizer and the training step. Counterpart of
`stablemtl_tpu/train_state.py`.

The step is the JAX package's `loss_fn` (train_state.py:211-235): one
batched VAE encode of [rgb; rgb_next; gt] under no_grad, the main UNet's
forward with the frozen child's features (`unet_forward(train=True)`), and a
masked MSE against the GT latent over the 8x invalid-dominant pooled valid
mask. The main UNet's f32 parameters are the trainable leaves; it computes
in its config's dtype (bf16 over f32 master weights in the flagship
recipe). Per-step randomness (input noise, task masking) comes from a
generator derived from (base_seed, step) alone.

`Optimizer` reproduces the JAX package's optax chain, whose semantics differ
from torch.optim's: MultiSteps(apply_if_finite(chain(clip_by_global_norm,
adam | adamw | adafactor), N)), the inner pieces as configured:
- `clip_by_global_norm`: g / ||g|| * max_norm when ||g|| >= max_norm, with
  no epsilon (torch's clip_grad_norm_ adds 1e-6 to the norm);
- Adam, or AdamW with optax's default weight decay 1e-4 (torch's is 1e-2),
  the first moment optionally stored in `mu_dtype` at optax's cast points;
- Adafactor as `optax.adafactor(lr, multiply_by_parameter_scale=False,
  clipping_threshold=None)`: factored second moments of every leaf with two
  dimensions of at least 128 (the two largest of the Flax layout), the
  others' kept whole, decay 1 - (t+1)^-0.8, epsilon 1e-30, no momentum;
- the schedule's count starts at 0 (the first update has lr(0), which is 0
  under warmup) and counts real updates only;
- `apply_if_finite`: an update whose gradient holds a NaN or inf is
  skipped (state unchanged) until more than N come in a row, then goes
  through; it counts `notfinite_count`, `last_finite` and
  `total_notfinite`;
- `MultiSteps`: the mean of k micro-steps' grads, one update every k; the
  mean is reset by multiplying it by 0, so a non-finite entry stays;
- a leaf that autograd leaves without a grad gets a zero grad and is
  updated (its moments decay), as optax does; torch.optim skips it.
Parameters and moments are updated in place, each step of the update one
multi-tensor (`torch._foreach_*`) call over all leaves where the math is
elementwise: the main UNet has 1070 leaves, and one eager call per leaf and
step held the host far behind the card. Adafactor's factored leaves take a
few calls each (their row and column means).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .pipeline import StableMTLPipeline
from .utils.loss import masked_mean
from .utils.profiling import span
from .utils.schedules import iter_exponential_ratio
from .utils.seeding import step_generator

ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default
# optax.adafactor's defaults
ADAFACTOR_MIN_DIM_TO_FACTOR = 128
ADAFACTOR_DECAY = 0.8
ADAFACTOR_EPS = 1e-30
OPTIMIZERS = ("adam", "adamw", "adafactor")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 1e-4
    max_grad_norm: float = 5.0
    total_iters: int = 25_000
    final_ratio: float = 0.01
    warmup_steps: int = 100
    accumulation_steps: int = 1
    use_schedule: bool = True
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    optimizer: str = "adam"                # adam | adamw | adafactor
    mu_dtype: Optional[str] = None         # Adam's first moment, e.g. bf16
    skip_nonfinite_updates: int = 0        # 0 off; N: apply_if_finite(N)


def flax_axes(name: str, ndim: int) -> tuple:
    """The axes of a port parameter in the order of its Flax leaf: a Dense
    or conv `weight` ([out, in], OIHW) is the Flax kernel ([in, out], HWIO)
    transposed; every other leaf (biases, norms, the stacked task banks)
    has the Flax layout."""
    if name.endswith(".weight") and ndim == 2:
        return (1, 0)
    if name.endswith(".weight") and ndim == 4:
        return (2, 3, 1, 0)
    return tuple(range(ndim))


def factored_dims(shape, axes=None) -> Optional[Tuple[int, int]]:
    """optax's `_factored_dims` on the Flax-order shape (`axes`: the
    parameter's axes in Flax order, `flax_axes`), mapped back to the
    parameter's own axes: (d1, d0), the second largest and the largest
    dimension, or None when the second largest is below 128. Factoring
    the Flax order keeps optax's choice where two dimensions tie."""
    axes = tuple(range(len(shape))) if axes is None else tuple(axes)
    if len(shape) < 2:
        return None
    order = np.argsort([shape[a] for a in axes])
    if shape[axes[order[-2]]] < ADAFACTOR_MIN_DIM_TO_FACTOR:
        return None
    return axes[int(order[-2])], axes[int(order[-1])]


class Optimizer:
    """The JAX package's optimizer (see the module docstring) on a list of
    f32 tensors updated in place. axes: per parameter, its axes in Flax
    order (`flax_axes`), which Adafactor factors; by default each
    parameter's own.

    The per-leaf state (moments, accumulated gradient) is kept in the
    layout the hooks `local`, `full`, `_local_shape`, `_whole_shape`,
    `_global_norm`, `_all_finite` and `_add_update` give: here every leaf
    whole; `parallel.sharded_train.ShardedOptimizer` keeps this rank's
    slices (ZeRO-1) and tensor-parallel shards."""

    def __init__(self, params, cfg: OptimizerConfig, axes=None):
        if cfg.optimizer not in OPTIMIZERS:
            raise ValueError(f"optimizer {cfg.optimizer!r} is not one of "
                             f"{OPTIMIZERS}")
        self.cfg = cfg
        self.params = list(params)
        self.axes = None if axes is None else list(axes)

        def zeros(i, p, dtype=None):
            return p.new_zeros(self._local_shape(i, p.shape),
                               dtype=dtype or p.dtype)

        if cfg.optimizer == "adafactor":
            axes = self.axes or [None] * len(self.params)
            shapes = [self._whole_shape(i, p)
                      for i, p in enumerate(self.params)]
            self.dims = [factored_dims(s, a) for s, a in zip(shapes, axes)]
            # factored statistics stay whole: they are small, and need the
            # whole gradient
            self.v_row = [None if d is None else p.new_zeros(
                _drop(s, d[1])) for p, s, d in zip(self.params, shapes,
                                                   self.dims)]
            self.v_col = [None if d is None else p.new_zeros(
                _drop(s, d[0])) for p, s, d in zip(self.params, shapes,
                                                   self.dims)]
            self.v = [zeros(i, p) if d is None else None
                      for i, (p, d) in enumerate(zip(self.params, self.dims))]
        else:
            mu_dtype = (None if cfg.mu_dtype is None
                        else getattr(torch, str(cfg.mu_dtype)))
            self.mu = [zeros(i, p, mu_dtype)
                       for i, p in enumerate(self.params)]
            self.nu = [zeros(i, p) for i, p in enumerate(self.params)]
        self.count = 0      # real updates so far: the moments' and schedule's
        self.mini_step = 0  # micro-steps into the current accumulation
        self.acc = ([zeros(i, p) for i, p in enumerate(self.params)]
                    if cfg.accumulation_steps > 1 else None)
        # apply_if_finite's counters
        self.notfinite_count = 0
        self.last_finite = True
        self.total_notfinite = 0

    # the per-leaf state shaped like its parameter, which `local` cuts;
    # Adafactor's factored statistics have shapes of their own and stay
    # whole
    PARAM_SHAPED = ("mu", "nu", "v")

    def moments(self) -> Dict[str, list]:
        """The per-leaf state by name, each a list aligned with the
        parameters (None where a leaf has none): Adam's mu and nu, or
        Adafactor's v_row, v_col and v."""
        if self.cfg.optimizer == "adafactor":
            return {"v_row": self.v_row, "v_col": self.v_col, "v": self.v}
        return {"mu": self.mu, "nu": self.nu}

    # -- layout hooks: every leaf whole -------------------------------------

    def local(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """The part of leaf i's whole tensor `t` this optimizer keeps."""
        return t

    def _whole_shape(self, i: int, p) -> tuple:
        """Leaf i's whole shape (parameter p's, unless p is a shard)."""
        return tuple(p.shape)

    def full(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """Leaf i's whole tensor from the part `t` kept here (a collective
        where the part is a slice)."""
        return t

    def gathered(self, tensors):
        """(i, leaf i whole) for each per-leaf part in `tensors` (None
        where a leaf has none); `full` of every part, a collective every
        rank joins where parts are slices."""
        for i, t in enumerate(tensors):
            if t is not None:
                yield i, t

    def _local_shape(self, i: int, shape) -> tuple:
        return tuple(shape)

    def _global_norm(self, grads) -> torch.Tensor:
        return torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))

    def _all_finite(self, grads) -> bool:
        # the one host sync of an update: which branch to take
        return bool(torch.stack([torch.isfinite(g).all()
                                 for g in grads]).all())

    def _add_update(self, u) -> None:
        torch._foreach_add_(self.params, u)

    def learning_rate(self, count: int) -> float:
        cfg = self.cfg
        if not cfg.use_schedule:
            return cfg.lr
        return cfg.lr * iter_exponential_ratio(
            count, cfg.total_iters, cfg.final_ratio, cfg.warmup_steps)

    @torch.no_grad()
    def update(self, grads) -> bool:
        """Take one micro-step's grads (None for a leaf without one); apply
        an update every `accumulation_steps` calls. Returns whether the
        parameters changed."""
        grads = [self.local(i, torch.zeros_like(p) if g is None else g)
                 for i, (p, g) in enumerate(zip(self.params, grads))]
        k = self.cfg.accumulation_steps
        if k > 1:
            # running mean over the micro-steps (optax's Welford update)
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, self.mini_step + 1)
            torch._foreach_add_(self.acc, diff)
            del diff
            self.mini_step = (self.mini_step + 1) % k
            if self.mini_step:
                return False
            changed = self._apply_if_finite(self.acc)
            # MultiSteps resets the mean as (1 - emit) * acc: a NaN stays
            torch._foreach_mul_(self.acc, 0.0)
            return changed
        return self._apply_if_finite(grads)

    def _apply_if_finite(self, grads) -> bool:
        n = self.cfg.skip_nonfinite_updates
        if n <= 0:
            self._apply(grads)
            return True
        finite = self._all_finite(grads)
        self.last_finite = finite
        if finite:
            self.notfinite_count = 0
        else:
            self.notfinite_count += 1
            self.total_notfinite += 1
        if finite or self.notfinite_count > n:
            self._apply(grads)
            return True
        return False

    def _apply(self, grads):
        with span("stablemtl.train.apply", device=self.params[0].device):
            self._clip_and_update(grads)

    def _clip_and_update(self, grads):
        cfg = self.cfg
        norm = self._global_norm(grads)
        # optax: g where ||g|| < max_norm, else g / ||g|| * max_norm; one
        # factor on the card, so the host never waits for the norm
        g = list(torch._foreach_mul(grads, torch.where(
            norm < cfg.max_grad_norm, 1.0, cfg.max_grad_norm / norm)))
        lr = self.learning_rate(self.count)
        self.count += 1
        # each takes g over and empties it once it is done with it, so the
        # clipped gradients are freed before the update's temporaries
        u = (self._adafactor(g) if cfg.optimizer == "adafactor"
             else self._adam(g))
        if cfg.optimizer == "adamw":
            torch._foreach_add_(u, [self.local(i, p) for i, p in enumerate(
                self.params)], alpha=ADAMW_WEIGHT_DECAY)
        torch._foreach_mul_(u, -lr)
        self._add_update(u)

    def _adam(self, g):
        """optax.scale_by_adam: (mu / bc1) / (sqrt(nu / bc2) + eps), the
        moments updated in place."""
        cfg = self.cfg
        # bias corrections in f32, as optax takes them: at b2=0.999 they
        # differ from the exact ones by up to 1.3e-5 relative
        bc1, bc2 = (float(np.float32(1) - np.power(
            np.float32(b), np.float32(self.count), dtype=np.float32))
            for b in (cfg.b1, cfg.b2))
        if self.mu[0].dtype == torch.float32:
            torch._foreach_mul_(self.mu, cfg.b1)
            torch._foreach_add_(self.mu, g, alpha=1.0 - cfg.b1)
            mu = self.mu
        else:
            # optax: (1 - b1) * g + b1 * mu with mu in mu_dtype, where b1 (a
            # weak-typed Python float) is rounded to mu_dtype; compiled, as
            # the JAX package's step always is, XLA keeps b1 * mu in f32
            # (exact) and fuses the sum into one rounding to f32. Both
            # products are exact in f64, so the f64 sum rounded to f32 is
            # that result. Updates come from the f32 mu, and mu is cast
            # back to mu_dtype for the state.
            b1 = float(torch.tensor(cfg.b1, dtype=self.mu[0].dtype))
            c1 = float(np.float32(1.0 - cfg.b1))
            mu = [(gi.double() * c1).add_(m.double(), alpha=b1).float()
                  for gi, m in zip(g, self.mu)]
        torch._foreach_mul_(self.nu, cfg.b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - cfg.b2)
        g.clear()
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        u = torch._foreach_div(mu, bc1)
        torch._foreach_div_(u, denom)
        if mu is not self.mu:
            for dst, src in zip(self.mu, mu):
                dst.copy_(src)
        return u

    def _adafactor(self, g):
        """optax.scale_by_factored_rms (no momentum, no clipping, no
        parameter scale): g / sqrt(V), V the running mean of g^2 + 1e-30,
        factored as v_row v_col / mean(v_row) on a leaf's two largest
        dimensions."""
        # decay 1 - (t + 1)^-0.8 at the update count t, in f32
        decay = float(np.float32(1) - np.power(
            np.float32(self.count), np.float32(-ADAFACTOR_DECAY),
            dtype=np.float32))
        rest = float(np.float32(1) - np.float32(decay))
        whole = [i for i, d in enumerate(self.dims) if d is None]
        if whole:
            sq = list(torch._foreach_mul([g[i] for i in whole],
                                         [g[i] for i in whole]))
            torch._foreach_add_(sq, ADAFACTOR_EPS)
            v = [self.v[i] for i in whole]
            torch._foreach_mul_(v, decay)
            torch._foreach_add_(v, sq, alpha=rest)
            del sq
        u = [None] * len(g)
        for i, d in enumerate(self.dims):
            if d is None:
                continue
            d1, d0 = d
            # the whole gradient: the statistics are means over its axes
            gi = self.full(i, g[i])
            g[i] = None
            sq = gi * gi + ADAFACTOR_EPS
            vr, vc = self.v_row[i], self.v_col[i]
            vr.mul_(decay).add_(sq.mean(d0), alpha=rest)
            vc.mul_(decay).add_(sq.mean(d1), alpha=rest)
            del sq
            # v_row lost axis d0: d1 moved down one when it came after it
            row_mean = vr.mean(d1 - 1 if d1 > d0 else d1, keepdim=True)
            u[i] = self.local(i, gi * torch.rsqrt(vr / row_mean).unsqueeze(
                d0) * torch.rsqrt(vc).unsqueeze(d1))
        if whole:
            for i, r in zip(whole, torch._foreach_rsqrt(
                    [self.v[i] for i in whole])):
                u[i] = r.mul_(g[i])
        g.clear()
        return u


def _drop(shape, axis: int) -> tuple:
    return tuple(s for i, s in enumerate(shape) if i != axis)


def make_optimizer(params, cfg: OptimizerConfig, axes=None) -> Optimizer:
    return Optimizer(params, cfg, axes)


@dataclasses.dataclass
class TrainState:
    step: int                                   # micro-step counter
    params: Dict[str, torch.nn.Parameter]       # trainable leaves, by name
    opt: Optional[Optimizer] = None
    # tensor parallelism: the parameters' split over the model axis
    # (parallel.tensor_parallel.TPLayout); None: every parameter whole
    layout: Optional[object] = None

    def split(self) -> Optional[list]:
        """Per parameter, whether the model axis splits it; None without
        tensor parallelism."""
        if self.layout is None:
            return None
        return [self.layout.sharded(n) for n in self.params]

    def apply_gradients(self, grads) -> "TrainState":
        self.opt.update(grads)
        self.step += 1
        return self


def _trainable(unet: torch.nn.Module) -> Dict[str, torch.nn.Parameter]:
    return {n: p for n, p in unet.named_parameters() if p.requires_grad}


def create_train_state(unet: torch.nn.Module, cfg: OptimizerConfig,
                       optimizer: Callable = make_optimizer) -> TrainState:
    """The trainable parameters of `unet` (those with requires_grad) and an
    optimizer over them, made by `optimizer(params, cfg, axes)`."""
    params = _trainable(unet)
    if not params:
        raise ValueError("the UNet has no trainable parameters: build the "
                         "pipeline with trainable=True")
    return TrainState(step=0, params=params, opt=optimizer(
        params.values(), cfg,
        [flax_axes(n, p.dim()) for n, p in params.items()]))


def eval_state(unet: torch.nn.Module, step: int = 0) -> TrainState:
    """Parameters only, no optimizer moments (eval and serving)."""
    return TrainState(step=step, params=dict(unet.named_parameters()))


# ---------------------------------------------------------------------------
# Loss pieces
# ---------------------------------------------------------------------------

def downsample_valid_mask(valid_mask):
    """8x invalid-dominant max-pool of the pixel valid mask [B, H, W, 1] ->
    latent mask [B, H/8, W/8, 1]: a latent cell is valid only if all 8x8
    pixels under it are valid."""
    invalid = (~valid_mask.bool()).float().permute(0, 3, 1, 2)
    return (F.max_pool2d(invalid, 8, 8) < 0.5).permute(0, 2, 3, 1)


def compute_grad_norm_stats(grads, split=None, mesh=None):
    """Mean and (population) std of the per-leaf gradient norms. `split`
    (per leaf, whether it is a tensor-parallel shard) with `mesh`: a
    shard's squared norm is summed over the model group first."""
    norms = torch.stack(torch._foreach_norm(grads))
    if split is not None and any(split):
        is_split = torch.tensor(split, device=norms.device)
        sq = mesh.model_all_reduce(torch.where(is_split, norms.square(),
                                               0.0))
        norms = torch.where(is_split, sq.sqrt(), norms)
    return norms.mean(), norms.std(unbiased=False)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def make_train_step(pipeline: StableMTLPipeline, base_seed: int = 0,
                    compute_grad_stats: bool = False,
                    mesh=None) -> Callable:
    """The training step: (state, batch) -> (state, metrics).

    batch: `rgb_norm`, `rgb_next_norm`, `target_3ch` NHWC float [-1, 1],
    bool `valid_mask` [B, H, W, 1] (tensors or numpy arrays) and an int
    `task_idx`; the task is data. `step.loss_and_grads(state, batch,
    generator=None)` gives (loss, pred, grads) without updating; a given
    generator replaces the step's own (`step_generator(base_seed, step)`),
    so a caller can read the state the masking left it in.

    mesh (`parallel.mesh.Mesh`): the batch is this rank's rows of a global
    batch, and the step is the global batch's: the loss is divided by the
    global mask count (all-reduced before the backward), the pipeline
    runs under `data_parallel(mesh)` (the banks' masking statistic and the
    input noise are the global batch's), the gradients are all-reduced as
    a sum in flat buckets, and loss and metrics are the global ones. Each
    of these reductions runs over the data group only: model peers hold
    the same rows and draw the same randomness.
    `parallel.sharded_train.make_sharded_train_step` builds this.

    Spans (`utils.profiling`): `stablemtl.train.forward` (the batch to
    the device, the encodes, the UNet forward, the loss),
    `stablemtl.train.backward` (the gradients, made contiguous) and
    `stablemtl.train.update` (`apply_gradients`, with device events);
    the optimizer's clip and update at a boundary are
    `stablemtl.train.apply`, inside the update.
    """
    device = pipeline.device

    def loss_fn(batch, generator):
        b = {key: torch.as_tensor(batch[key], device=device)
             for key in ("rgb_norm", "rgb_next_norm", "target_3ch",
                         "valid_mask")}
        with torch.no_grad():
            lat_all = pipeline.encode_rgb(torch.cat(
                [b["rgb_norm"], b["rgb_next_norm"], b["target_3ch"]]))
        lat, lat_next, gt_latent = lat_all.chunk(3)
        pred = pipeline.unet_forward(lat, lat_next, int(batch["task_idx"]),
                                     generator=generator, train=True)
        mask = downsample_valid_mask(b["valid_mask"]).expand(pred.shape)
        count = None
        if mesh is not None:
            # the masked mean of the global batch: each rank's masked sum
            # over the global count
            count = mask.sum(dtype=torch.float32)
            mesh.all_reduce_([count])
        # prediction_type 'sample': the target is the GT latent
        loss = masked_mean((pred.float() - gt_latent.float()) ** 2, mask,
                           count)
        return loss, pred

    def loss_and_grads(state: TrainState, batch, generator=None):
        if generator is None:
            generator = step_generator(base_seed, state.step, device)
        params = list(state.params.values())
        with pipeline.data_parallel(mesh):
            with span("stablemtl.train.forward"):
                loss, pred = loss_fn(batch, generator)
            with span("stablemtl.train.backward"):
                # zeros for a leaf outside the graph, as jax.grad gives
                grads = torch.autograd.grad(loss, params,
                                            materialize_grads=True)
                grads = [g.contiguous() for g in grads]
        loss = loss.detach()
        if mesh is not None:
            mesh.all_reduce_(grads)
            mesh.all_reduce_([loss])
        return loss, pred.detach(), grads

    def step(state: TrainState, batch):
        loss, pred, grads = loss_and_grads(state, batch)
        nan_pred = torch.isnan(pred).any().float()
        if mesh is not None:
            mesh.all_reduce_([nan_pred])
        metrics = {"loss": loss, "nan_pred": nan_pred}
        if compute_grad_stats:
            gmean, gstd = compute_grad_norm_stats(grads, state.split(), mesh)
            metrics.update(grad_norm_mean=gmean, grad_norm_std=gstd)
        del pred
        with span("stablemtl.train.update", device=device):
            state.apply_gradients(grads)
        return state, metrics

    step.loss_and_grads = loss_and_grads
    return step


def make_eval_step(pipeline: StableMTLPipeline) -> Callable:
    """Inference step: batch -> clipped 3-channel prediction [B, H, W, 3] of
    batch['task_idx'], with the pipeline's current parameters."""

    def step(batch):
        return pipeline.infer(batch["rgb_norm"], batch["rgb_next_norm"],
                              int(batch["task_idx"]))

    return step


def make_eval_tasks_step(pipeline: StableMTLPipeline) -> Callable:
    """Subset multi-task inference with the pipeline's current parameters
    (in training, the live trainable ones): (rgb, rgb_next or None,
    task_indices [K]) -> [K, B, H, W, 3]; the VAE encode and the child taps
    are shared by the K tasks. Runs under `torch.inference_mode()`
    (`pipeline.infer_tasks`)."""

    def step(rgb_norm, rgb_next_norm, task_indices):
        return pipeline.infer_tasks(rgb_norm, rgb_next_norm, task_indices)

    return step
