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

`Optimizer` reproduces optax's semantics, which differ from torch.optim's:
- `clip_by_global_norm`: g / ||g|| * max_norm when ||g|| >= max_norm, with
  no epsilon (torch's clip_grad_norm_ adds 1e-6 to the norm);
- Adam, or AdamW with optax's default weight decay 1e-4 (torch's is 1e-2);
- the schedule's count starts at 0 (the first update has lr(0), which is 0
  under warmup) and counts real updates only;
- `MultiSteps`: the mean of k micro-steps' grads, one update every k;
- a leaf that autograd leaves without a grad gets a zero grad and is
  updated (its moments decay), as optax does; torch.optim skips it.
Parameters and moments are updated in place, each step of the update one
multi-tensor (`torch._foreach_*`) call over all leaves: the main UNet has
1070 leaves, and one eager call per leaf and step held the host far behind
the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .pipeline import StableMTLPipeline
from .utils.loss import masked_mean
from .utils.schedules import iter_exponential_ratio
from .utils.seeding import step_generator

ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default


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
    optimizer: str = "adam"                # adam | adamw (adafactor: not yet)
    mu_dtype: Optional[str] = None         # not ported: must stay None
    skip_nonfinite_updates: int = 0        # not ported: must stay 0


class Optimizer:
    """MultiSteps(chain(clip_by_global_norm, adam | adamw)) with the
    IterExponential schedule, in optax's semantics, on a list of f32
    tensors updated in place."""

    def __init__(self, params, cfg: OptimizerConfig):
        if cfg.optimizer == "adafactor":
            raise NotImplementedError("adafactor is not ported yet")
        if cfg.optimizer not in ("adam", "adamw"):
            raise ValueError(cfg.optimizer)
        if cfg.mu_dtype is not None:
            raise NotImplementedError("mu_dtype is not ported yet")
        if cfg.skip_nonfinite_updates:
            raise NotImplementedError(
                "skip_nonfinite_updates (apply_if_finite) is not ported yet")
        self.cfg = cfg
        self.params = list(params)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0      # real updates so far: Adam's and the schedule's
        self.mini_step = 0  # micro-steps into the current accumulation
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if cfg.accumulation_steps > 1 else None)

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
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
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
            self._apply(self.acc)
            torch._foreach_zero_(self.acc)
            return True
        self._apply(grads)
        return True

    def _apply(self, grads):
        cfg = self.cfg
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        # optax: g where ||g|| < max_norm, else g / ||g|| * max_norm; one
        # factor on the card, so the host never waits for the norm
        g = torch._foreach_mul(grads, torch.where(
            norm < cfg.max_grad_norm, 1.0, cfg.max_grad_norm / norm))
        lr = self.learning_rate(self.count)
        self.count += 1
        # Adam's bias corrections in f32, as optax takes them: at b2=0.999
        # they differ from the exact ones by up to 1.3e-5 relative
        bc1, bc2 = (float(np.float32(1) - np.power(
            np.float32(b), np.float32(self.count), dtype=np.float32))
            for b in (cfg.b1, cfg.b2))
        torch._foreach_mul_(self.mu, cfg.b1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - cfg.b1)
        torch._foreach_mul_(self.nu, cfg.b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - cfg.b2)
        del g
        # u = (mu / bc1) / (sqrt(nu / bc2) + eps)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        u = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(u, denom)
        del denom
        if cfg.optimizer == "adamw":
            torch._foreach_add_(u, self.params, alpha=ADAMW_WEIGHT_DECAY)
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(self.params, u)


def make_optimizer(params, cfg: OptimizerConfig) -> Optimizer:
    return Optimizer(params, cfg)


@dataclasses.dataclass
class TrainState:
    step: int                                   # micro-step counter
    params: Dict[str, torch.nn.Parameter]       # trainable leaves, by name
    opt: Optional[Optimizer] = None

    def apply_gradients(self, grads) -> "TrainState":
        self.opt.update(grads)
        self.step += 1
        return self


def _trainable(unet: torch.nn.Module) -> Dict[str, torch.nn.Parameter]:
    return {n: p for n, p in unet.named_parameters() if p.requires_grad}


def create_train_state(unet: torch.nn.Module,
                       cfg: OptimizerConfig) -> TrainState:
    """The trainable parameters of `unet` (those with requires_grad) and an
    optimizer over them."""
    params = _trainable(unet)
    if not params:
        raise ValueError("the UNet has no trainable parameters: build the "
                         "pipeline with trainable=True")
    return TrainState(step=0, params=params,
                      opt=make_optimizer(params.values(), cfg))


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


def compute_grad_norm_stats(grads):
    """Mean and (population) std of the per-leaf gradient norms."""
    norms = torch.stack(torch._foreach_norm(grads))
    return norms.mean(), norms.std(unbiased=False)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def make_train_step(pipeline: StableMTLPipeline, base_seed: int = 0,
                    compute_grad_stats: bool = False) -> Callable:
    """The training step: (state, batch) -> (state, metrics).

    batch: `rgb_norm`, `rgb_next_norm`, `target_3ch` NHWC float [-1, 1],
    bool `valid_mask` [B, H, W, 1] (tensors or numpy arrays) and an int
    `task_idx`; the task is data. `step.loss_and_grads(state, batch)` gives
    (loss, pred, grads) without updating.
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
        mask = downsample_valid_mask(b["valid_mask"])
        # prediction_type 'sample': the target is the GT latent
        loss = masked_mean((pred.float() - gt_latent.float()) ** 2,
                           mask.expand(pred.shape))
        return loss, pred

    def loss_and_grads(state: TrainState, batch):
        generator = step_generator(base_seed, state.step, device)
        params = list(state.params.values())
        loss, pred = loss_fn(batch, generator)
        # zeros for a leaf outside the graph, as jax.grad gives
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
        return loss.detach(), pred.detach(), list(grads)

    def step(state: TrainState, batch):
        loss, pred, grads = loss_and_grads(state, batch)
        metrics = {"loss": loss,
                   "nan_pred": torch.isnan(pred).any().float()}
        if compute_grad_stats:
            gmean, gstd = compute_grad_norm_stats(grads)
            metrics.update(grad_norm_mean=gmean, grad_norm_std=gstd)
        del pred
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
