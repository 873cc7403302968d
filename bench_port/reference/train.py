"""The plain reference of the flagship training step, in float32, on any
`Reference` of the contract in `pipeline.py`.

A micro-step: its forward from the reference (`train_inputs`: one VAE
encode of [rgb; rgb_next; target] (latent means) and the frozen child's
taps of the 6 auxiliary tasks; `train_pred`: the main UNet for the
micro-step's task with its banks attending over those tasks), the
masked mean squared error to the target's latent over the latent cells
whose 8x8 pixels are all valid, and its gradient in the main UNet's
parameters. An update every `accumulation` micro-steps: the mean of
their gradients, clipped to a global norm of `clip` (no epsilon),
then Adam (bias-corrected, eps outside the square root) at the
learning rate of the step's schedule (IterExponential with linear
warm-up; the first update's rate is 0).

The banks' task masking draws from the micro-step's generator, layer
after layer: a gate, then one key by its mean attention. A draw is the
same on both sides except where rounding turns a near tie (`NEAR_TIE`):
the reference then follows the pick the program made, and any other
difference counts as a mismatch. The draws need the whole batch's mean
attention, so a first pass without gradients makes them and a second
pass computes the gradient in blocks of rows under the same masks.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

NEAR_TIE = 1e-2
CHUNK = 4         # rows a block of the encodes, the child and the gradient
B1, B2, EPS = 0.9, 0.999, 1e-8


def step_seed(base_seed: int, step: int) -> int:
    """The seed of micro-step `step`'s generator: the program's documented
    derivation from (base seed, step) (utils/seeding.step_generator)."""
    seq = np.random.SeedSequence([int(base_seed) & 0xFFFF_FFFF, int(step)])
    return int(seq.generate_state(1, dtype=np.uint64)[0])


def latent_valid(valid):
    """[B, H, W, 1] bool pixels -> [B, H/8, W/8, 1]: a latent cell is valid
    when all 8x8 pixels under it are."""
    invalid = (~valid.bool()).float().permute(0, 3, 1, 2)
    return (F.max_pool2d(invalid, 8, 8) < 0.5).permute(0, 2, 3, 1)


def lr_at(count: int, opt: dict) -> float:
    """IterExponential: linear warm-up over `warmup` updates, then an
    exponential decay to `final_ratio` at `total`."""
    n, w, total = float(count), opt["warmup"], opt["total"]
    if n < w:
        ratio = n / w
    elif n >= total:
        ratio = opt["final_ratio"]
    else:
        ratio = math.exp((n - w) / (total - w) * math.log(opt["final_ratio"]))
    return opt["lr"] * ratio


def draws_of_masks(masks) -> list:
    """The (gate, pick) of each [K, T] task mask the program applied."""
    out = []
    for m in masks:
        gate = (m < -1e8).any(dim=-1)
        out.append((gate, m.argmin(dim=-1)))
    return out


class Trainer:
    """The reference's training state: the main UNet's parameters (the
    reference's own modules, trainable), Adam's moments and the
    accumulated gradient."""

    def __init__(self, ref, opt: dict):
        self.ref, self.opt = ref, opt
        self.names = [n for n, _ in ref.unet.named_parameters()]
        self.params = [p for _, p in ref.unet.named_parameters()]
        for p in self.params:
            p.requires_grad_(True)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.micro = 0
        self.count = 0
        self.first_grad = None       # the first update's gradient (host)
        self.mismatches = 0
        self.ties = 0
        self.last_masks = []         # the last micro-step's task masks

    def _masker(self, bank, generator, program, layer, masks):
        def masker(scores):
            gate, pick, margin = bank.draw(scores, generator)
            if program is not None:
                p_gate, p_pick = program[layer]
                differ = gate & (pick != p_pick.to(pick.device))
                if bool((gate != p_gate.to(gate.device)).any()):
                    self.mismatches += 1
                if bool(differ.any()):
                    if bool((margin[differ] < NEAR_TIE).all()):
                        self.ties += 1
                    else:
                        self.mismatches += 1
                    pick = torch.where(differ, p_pick.to(pick.device), pick)
            m = bank.mask_of(gate, pick, scores.shape[-1])
            masks.append(m)
            return m
        return masker

    def micro_step(self, batch: dict, task: int,
                   generator: torch.Generator,
                   program_draws: Optional[Sequence] = None) -> float:
        """One micro-step on `batch` (rgb_norm, rgb_next_norm, target_3ch
        [B, H, W, 3], valid_mask [B, H, W, 1] on the card); returns the
        loss and accumulates the gradient. program_draws: the (gate, pick)
        the program drew at each bank, to follow at near ties."""
        ref, c = self.ref, CHUNK
        rgb, nxt, tgt = (batch[k].float() for k in
                         ("rgb_norm", "rgb_next_norm", "target_3ch"))
        B = rgb.shape[0]
        inputs = ref.train_inputs(rgb, nxt, tgt, task, block=c)
        gt = inputs.target
        mask = latent_valid(batch["valid_mask"]).expand(gt.shape).float()
        count = mask.sum().clamp(min=1.0)
        masks = []
        with torch.no_grad():
            ref.train_pred(inputs, task, maskers=[
                self._masker(b, generator, program_draws, li, masks)
                for li, b in enumerate(ref.unet.banks())])
        self.last_masks = masks
        fixed = [lambda s, m=m: m for m in masks]
        loss = 0.0
        grads = [torch.zeros_like(p) for p in self.params]
        for i in range(0, B, c):
            sl = slice(i, i + c)
            pred = ref.train_pred(inputs, task, rows=sl, maskers=fixed)
            part = ((pred - gt[sl]) ** 2 * mask[sl]).sum() / count
            for g, d in zip(grads, torch.autograd.grad(
                    part, self.params, allow_unused=True)):
                if d is not None:
                    g.add_(d)
            loss += float(part.detach())
        self._accumulate(grads)
        return loss

    def _accumulate(self, grads) -> None:
        k = self.opt["accumulation"]
        for a, g in zip(self.acc, grads):
            a.add_(g, alpha=1.0 / k)
        self.micro += 1
        if self.micro % k == 0:
            self._update(self.acc)
            self.acc = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def _update(self, g) -> None:
        norm = torch.sqrt(sum((x.double() ** 2).sum() for x in g))
        clip = self.opt["clip"]
        factor = 1.0 if float(norm) < clip else clip / float(norm)
        g = [x * factor for x in g]
        if self.first_grad is None:
            self.first_grad = [x.cpu() for x in g]
        lr = lr_at(self.count, self.opt)
        self.count += 1
        bc1, bc2 = 1 - B1 ** self.count, 1 - B2 ** self.count
        for p, m, v, x in zip(self.params, self.mu, self.nu, g):
            m.mul_(B1).add_(x, alpha=1 - B1)
            v.mul_(B2).addcmul_(x, x, value=1 - B2)
            p.sub_(lr * (m / bc1) / ((v / bc2).sqrt() + EPS))
