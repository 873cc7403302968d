"""The plain reference of StableMTL's all-task inference, in float32.

`Reference` holds the plain modules of one configuration (`model.py`) and
the task text table, all made from the weights the benchmark hands it.
`infer_all_tasks` follows the published single-step method: the VAE's
latent mean of the image, the frozen child UNet's self-attention taps for
all 7 tasks (multi-stream only), the main UNet once per task, its banks
attending per pixel over the other tasks' projected taps, and the VAE
decode of each task's latent, clipped to [-1, 1].
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .model import UNet, UNetSpec, VAE, VAESpec

N_TASKS = 7
# the tasks that read the second frame (optical_flow, scene_flow)
TWO_FRAME = (False, False, False, True, True, False, False)


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


@dataclasses.dataclass
class Reference:
    vae: VAE
    unet: UNet
    text: torch.Tensor                    # [7, L, D] f32
    child: Optional[UNet] = None

    @classmethod
    def from_weights(cls, config: dict, weights: dict, text, device):
        """The plain modules on `device` with the benchmark's weights
        (`weights[module][name]`), in float32."""
        mods = build(config, "meta")
        for key, m in mods.items():
            state = {n: w.to(device=device, dtype=torch.float32)
                     for n, w in weights[key].items()}
            m.load_state_dict(state, strict=True, assign=True)
            m.requires_grad_(False)
        return cls(vae=mods["vae"], unet=mods["unet"],
                   text=text.to(device=device, dtype=torch.float32),
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
