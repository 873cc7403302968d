"""The plain reference of StableMTL's all-task inference, in float32, on
SD2's UNet and VAE.

`Reference` holds the plain modules of one configuration (`model.py`) and
the task text table, all made from the weights the benchmark hands it.
`infer_all_tasks` follows the published single-step method: the VAE's
latent mean of the image, the frozen child UNet's self-attention taps for
all 7 tasks (multi-stream only), the main UNet once per task, its banks
attending per pixel over the other tasks' projected taps, and the VAE
decode of each task's latent, clipped to [-1, 1].

A configuration file names its plain reference by the key "reference": a
module of this package, this one for SD2's layout. The harness reaches a
model's math only through that module, so a model of another layout
comes as a new module beside this one. A reference module gives:

- `N_TASKS`, the tasks, and `TWO_FRAME`, which of them read a second
  frame.
- `build(config, device)`: {"vae", "unet"[, "child"]}, the plain modules
  uninitialised; the order of their parameters is the order of the
  seeded weight draw, and "unet" is the module a training cell trains.
- `conditioning(config, seed, device)`: the seeded conditioning, {the
  program pipeline's attribute: tensor}, which the harness sets on the
  program (it must have each attribute, at the same shape) and hands to
  `Reference.from_weights`; `conditioning_shapes(config)`: their shapes,
  for the count on the meta device.
- `Reference`: `from_weights(config, weights, conditioning, device)`;
  `latents(rgb, rgb_next)`, `infer_all_tasks(rgb, rgb_next, block)`; a
  training micro-step's forward as `train_inputs(rgb, rgb_next, target,
  task, block)` then `train_pred(inputs, task, rows, maskers)`, one
  masker a task bank of the "unet", in the order of its `banks()`.
- `Trainer(reference, optimizer)`, for a configuration with a training
  cell (`train.Trainer` runs on any `Reference` of this contract).
- `TINY`: the overrides that shrink a configuration file for the CPU
  tests (a dict value is merged into the file's dict under its key).

What does not depend on the layout stays shared: `train.py`'s step
seeds, mask draws, schedule and Adam, and `precision.py`'s products. A
reference sends every product through `precision` (`linear`, `conv2d`,
`einsum`, `matmul`, and `note_attention` for each attention call):
otherwise the fp8 control and the attention count do not see it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..harness.program import generator
from .model import UNet, UNetSpec, VAE, VAESpec
from .train import Trainer  # noqa: F401 - this layout's trainer

N_TASKS = 7
# the tasks that read the second frame (optical_flow, scene_flow)
TWO_FRAME = (False, False, False, True, True, False, False)
# the program's tiny preset: the same topology at small widths
TINY = {"program_config": {"model": {"size_preset": "tiny"}},
        "model": dict(unet_block_out_channels=[32, 64, 64, 64],
                      unet_attention_heads=[2, 2, 2, 2],
                      cross_attention_dim=32, norm_groups=8,
                      vae_block_out_channels=[16, 32, 32, 32]),
        "text_tokens": 5}


def specs(config: dict):
    """(main UNet spec, child spec or None, VAE spec) of a configuration
    file's `model` section."""
    m = config["model"]
    unet = dict(block_out_channels=tuple(m["unet_block_out_channels"]),
                attention_heads=tuple(m["unet_attention_heads"]),
                layers_per_block=m["unet_layers_per_block"],
                cross_attention_dim=m["cross_attention_dim"],
                norm_groups=m["norm_groups"], n_tasks=N_TASKS)
    multi = bool(m["multi_stream"])
    main = UNetSpec(**unet, task_attention=multi, n_attns=m["n_attns"],
                    q_hidden=m["bank_q_hidden"],
                    q_hidden_layers=m["bank_q_hidden_layers"],
                    attn_mask_ratio=m["attn_mask_ratio"],
                    attn_mask_type=m["attn_mask_type"])
    child = UNetSpec(**unet) if multi else None
    vae = VAESpec(block_out_channels=tuple(m["vae_block_out_channels"]),
                  layers_per_block=m["vae_layers_per_block"],
                  norm_groups=m["norm_groups"],
                  scaling_factor=m["latent_scale_factor"])
    return main, child, vae


def build(config: dict, device="meta"):
    """{"vae", "unet"[, "child"]}: the plain modules, uninitialised, on
    `device` (meta: shapes only)."""
    main, child, vae = specs(config)
    with torch.device(device):
        mods = {"vae": VAE(vae), "unet": UNet(main)}
        if child is not None:
            mods["child"] = UNet(child)
    for m in mods.values():
        m.requires_grad_(False)
    return mods


def conditioning_shapes(config: dict) -> dict:
    return {"text_embed_table": (N_TASKS, config["text_tokens"],
                                 config["model"]["cross_attention_dim"])}


def conditioning(config: dict, seed: int, device) -> dict:
    """The task text table [7, L, D] (what `text_table.npy` holds for a
    converted checkpoint), N(0, 1) in bfloat16."""
    shape = conditioning_shapes(config)["text_embed_table"]
    return {"text_embed_table": torch.randn(
        shape, generator=generator(seed, "text", device), device=device,
        dtype=torch.bfloat16)}


@dataclasses.dataclass
class TrainInputs:
    """What a training micro-step's main UNet reads: its input [1, B, h,
    w, 12], the target's latent [B, h, w, 4], the other tasks `aux` and
    the child's taps of them, per layer [6, B, N, C]."""
    x: torch.Tensor
    target: torch.Tensor
    aux: list
    taps: list


@dataclasses.dataclass
class Reference:
    vae: VAE
    unet: UNet
    text: torch.Tensor                    # [7, L, D] f32
    child: Optional[UNet] = None

    @classmethod
    def from_weights(cls, config: dict, weights: dict, conditioning: dict,
                     device):
        """The plain modules on `device` with the benchmark's weights
        (`weights[module][name]`) and `conditioning`, in float32."""
        mods = build(config, "meta")
        for key, m in mods.items():
            state = {n: w.to(device=device, dtype=torch.float32)
                     for n, w in weights[key].items()}
            m.load_state_dict(state, strict=True, assign=True)
            m.requires_grad_(False)
        return cls(vae=mods["vae"], unet=mods["unet"],
                   text=conditioning["text_embed_table"].to(
                       device=device, dtype=torch.float32),
                   child=mods.get("child"))

    def _variants(self, lat, lat_next):
        """The distinct UNet inputs [V, B, h, w, 12] and each task's
        variant: [lat | lat | 0], and [lat | lat_next | 0] for the
        two-frame tasks when a second frame is given."""
        zeros = torch.zeros_like(lat)
        single = torch.cat([lat, lat, zeros], -1)
        if lat_next is None:
            return single[None], [0] * N_TASKS
        two = torch.cat([lat, lat_next, zeros], -1)
        return torch.stack([single, two]), [int(t) for t in TWO_FRAME]

    def _streams(self, unet, xv, pick, bank_args=None, tap=None):
        B = xv.shape[1]
        ctx = self.text.repeat_interleave(B, dim=0)       # rows k*B + b
        return unet(xv, pick, ctx, tap=tap, bank_args=bank_args)

    def latents(self, rgb, rgb_next=None):
        """The 7 tasks' latent predictions [7, B, h, w, 4] of images [B,
        H, W, 3] in [-1, 1]."""
        lat = self.vae.encode(rgb)
        lat_next = None if rgb_next is None else self.vae.encode(rgb_next)
        xv, pick = self._variants(lat, lat_next)
        B = lat.shape[0]
        bank_args = None
        if self.child is not None:
            _, taps = self._streams(self.child, xv, pick,
                                    tap="afterSelfAttn_residual")
            tasks = torch.arange(N_TASKS, device=lat.device)
            banks = self.unet.banks()
            kv = []
            for bank, tp in zip(banks, taps):
                feats = tp.unflatten(0, (N_TASKS, B))
                kv.append((bank.kv(feats, tasks, "k"),
                           bank.kv(feats, tasks, "v")))
            del taps
            # each stream attends over the other tasks
            key_bias = torch.where(torch.eye(N_TASKS, dtype=torch.bool,
                                             device=lat.device), -1e9, 0.0)

            def bank_args(li):
                return dict(k_all=kv[li][0], v_all=kv[li][1],
                            main_idx=tasks, key_bias=key_bias)

        pred, _ = self._streams(self.unet, xv, pick, bank_args=bank_args)
        return pred.unflatten(0, (N_TASKS, B))

    @torch.no_grad()
    def infer_all_tasks(self, rgb, rgb_next=None, block: int = 1):
        """[7, B, H, W, 3] in [-1, 1], `block` images at a time."""
        outs = []
        for i in range(0, rgb.shape[0], block):
            sl = slice(i, i + block)
            lat = self.latents(rgb[sl],
                               None if rgb_next is None else rgb_next[sl])
            img = torch.stack([self.vae.decode(z) for z in lat])
            outs.append(img.clamp(-1.0, 1.0))
        return torch.cat(outs, dim=1)

    @torch.no_grad()
    def train_inputs(self, rgb, rgb_next, target, task: int,
                     block: Optional[int] = None) -> TrainInputs:
        """The micro-step's inputs for the main task `task` from its
        images [B, H, W, 3]: one VAE encode of [rgb; rgb_next; target]
        and the frozen child's taps of the other tasks, `block` images a
        call (None: all at once)."""
        B = rgb.shape[0]
        images = torch.cat([rgb, rgb_next, target])
        step = block or 3 * B
        lat, lat_next, gt = torch.cat([self.vae.encode(images[i:i + step])
                                       for i in range(0, 3 * B, step)]
                                      ).chunk(3)
        aux = [t for t in range(N_TASKS) if t != task]
        zeros = torch.zeros_like(lat)
        xv = torch.stack([torch.cat([lat, lat, zeros], -1),
                          torch.cat([lat, lat_next, zeros], -1)])
        ctx = self.text[aux].repeat_interleave(B, dim=0)
        step = block or B
        taps = []
        for i in range(0, B, step):
            _, t = self.child(xv[:, i:i + step],
                              [int(TWO_FRAME[a]) for a in aux],
                              ctx.unflatten(0, (len(aux), B))[:, i:i + step]
                              .flatten(0, 1), tap="afterSelfAttn_residual")
            taps.append([x.unflatten(0, (len(aux), -1)) for x in t])
        taps = [torch.cat(parts, dim=1) for parts in zip(*taps)]
        return TrainInputs(x=xv[[int(TWO_FRAME[task])]], target=gt, aux=aux,
                           taps=taps)

    def train_pred(self, inputs: TrainInputs, task: int,
                   rows: slice = slice(None),
                   maskers: Optional[Sequence] = None):
        """The main UNet's latent prediction [n, h, w, 4] of the images
        `rows`, its banks attending over the other tasks' taps; maskers:
        per layer, the bank's task mask of its scores, or None."""
        x = inputs.x[:, rows]
        n, dev = x.shape[1], x.device
        banks = self.unet.banks()
        aux = torch.tensor(inputs.aux, device=dev)
        main = torch.tensor([task], device=dev)
        key_bias = torch.zeros((1, len(inputs.aux)), device=dev)

        def bank_args(li):
            taps = inputs.taps[li][:, rows]
            return dict(k_all=banks[li].kv(taps, aux, "k"),
                        v_all=banks[li].kv(taps, aux, "v"), main_idx=main,
                        key_bias=key_bias,
                        masker=None if maskers is None else maskers[li])

        pred, _ = self.unet(x, [0], self.text[[task]].repeat_interleave(n, 0),
                            bank_args=bank_args)
        return pred
