"""The plain reference of StableMTL's all-task inference over the SDXL
base UNet, in float32.

The same single-step method as `pipeline.py` (whose `Reference` this one
extends), on the UNet of stabilityai/stable-diffusion-xl-base-1.0
(`unet/config.json`): stages of 320, 640 and 1280 channels, no attention
in the 320 stage, 2 transformer blocks in each 640 attention layer and 10
in each 1280 layer and in the mid block, heads of 64, text
cross-attention of 2048, and the text-time added conditioning: a pooled
text embedding of 1280 and six time ids, each a 256-wide sinusoid,
through `add_embedding` into the timestep embedding. StableMTL's banks sit
on every transformer block's self-attention, 70 of them, and so do the
frozen child's taps. The VAE has SD2's layout at scaling factor 0.13025.

Departures from the published model, none of them in its widths or
depth:
- the two text encoders are not run: the task text table [7, L, 2048] and
  the pooled table [7, 1280] are inputs (`conditioning`, drawn from the
  seed), as a converted checkpoint would bring them;
- conv_in takes StableMTL's 12 input channels (rgb | rgb_next | noise
  latents), not 4;
- the time ids are (H, W, 0, 0, H, W) of the input: the image at its own
  size, uncropped;
- the transformer blocks' LayerNorms take eps 1e-6, as the SD2 layout of
  `model.py` and the program do (diffusers: 1e-5).

It reuses `model.py`'s blocks, and every product goes through
`precision`. This configuration has no training cell: no `Trainer`, and
`train_inputs` / `train_pred` raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..harness.program import generator
from . import pipeline
from .model import (VAE, Conv, GroupNorm, Holder, Linear, ResnetBlock,
                    TimestepEmbedding, TransformerBlock, UpsampleConv,
                    VAESpec, timestep_embedding)

N_TASKS = pipeline.N_TASKS
TWO_FRAME = pipeline.TWO_FRAME
# SDXL's time ids: original (H, W), crop (top, left), target (H, W)
N_TIME_IDS = 6
# the program's "sdxl_tiny" preset: the same topology at small widths
TINY = {"program_config": {"model": {"size_preset": "sdxl_tiny"}},
        "model": dict(unet_block_out_channels=[32, 64, 64],
                      unet_attention_heads=[2, 2, 2],
                      unet_transformer_layers=[1, 2, 3],
                      cross_attention_dim=32, addition_time_embed_dim=8,
                      pooled_text_dim=16, norm_groups=8,
                      vae_block_out_channels=[16, 32, 32, 32]),
        "text_tokens": 5}


@dataclasses.dataclass(frozen=True)
class Spec:
    """The UNet's layout; the bank fields are `model.UNetSpec`'s, which
    `model.TaskAttentionBank` reads."""
    in_channels: int = 12
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    attention_stages: Tuple[bool, ...] = (False, True, True)
    transformer_layers: Tuple[int, ...] = (1, 2, 10)
    layers_per_block: int = 2
    cross_attention_dim: int = 2048
    attention_heads: Tuple[int, ...] = (5, 10, 20)
    addition_time_embed_dim: int = 256
    pooled_text_dim: int = 1280
    norm_groups: int = 32
    n_tasks: int = N_TASKS
    task_attention: bool = False
    n_attns: int = 4
    q_hidden: int = 640
    q_hidden_layers: int = 2
    attn_mask_ratio: float = 0.0
    attn_mask_type: str = "attn_prob"


class Transformer2D(nn.Module):
    """GroupNorm -> proj_in -> `n` transformer blocks, each with its own
    bank and tap -> proj_out + residual."""

    def __init__(self, c, heads, n, spec: Spec):
        super().__init__()
        self.n = n
        self.norm = GroupNorm(spec.norm_groups, c, 1e-6)
        self.proj_in = Linear(c, c)
        for k in range(n):
            self.add_module(f"transformer_blocks_{k}", TransformerBlock(
                c, heads, spec.cross_attention_dim, spec.task_attention,
                spec))
        self.proj_out = Linear(c, c)

    def blocks(self):
        return [getattr(self, f"transformer_blocks_{k}")
                for k in range(self.n)]

    def forward(self, x, ctx, bank_args, tap: Optional[str]):
        """bank_args: one a block, the keyword arguments of its bank or
        None. Returns (out, taps: one a block, the tap
        'afterSelfAttn_residual' or None)."""
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W,
                                                                  C))
        taps = []
        for blk, args in zip(self.blocks(), bank_args):
            a1 = blk.attn1(blk.norm1(h))
            if hasattr(blk, "task_attn") and args is not None:
                a1 = a1 + blk.task_attn(a1, **args)
            h = h + a1
            h = h + blk.attn2(blk.norm2(h), ctx)
            h = h + blk.ff(blk.norm3(h))
            taps.append(a1 if tap == "afterSelfAttn_residual" else None)
        out = self.proj_out(h).reshape(B, H, W, C).permute(0, 3, 1, 2) + x
        return out, taps


class UNet(nn.Module):
    def __init__(self, spec: Spec):
        super().__init__()
        self.spec = s = spec
        ch, n = s.block_out_channels, len(s.block_out_channels)
        attn, temb, lpb = s.attention_stages, ch[0] * 4, s.layers_per_block

        def tr(c, stage):
            return Transformer2D(c, s.attention_heads[stage],
                                 s.transformer_layers[stage], s)

        def rn(cin, cout):
            return ResnetBlock(cin, cout, temb, s.norm_groups, 1e-5)

        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.add_embedding = TimestepEmbedding(
            s.pooled_text_dim + N_TIME_IDS * s.addition_time_embed_dim, temb)
        self.conv_in = Conv(s.in_channels, ch[0], 3, padding=1)
        cur, res = ch[0], [ch[0]]
        for i in range(n):
            for j in range(lpb):
                self.add_module(f"down_blocks_{i}_resnets_{j}", rn(cur, ch[i]))
                cur = ch[i]
                if attn[i]:
                    self.add_module(f"down_blocks_{i}_attentions_{j}",
                                    tr(cur, i))
                res.append(cur)
            if i < n - 1:
                self.add_module(f"down_blocks_{i}_downsamplers_0", Holder(
                    Conv(cur, cur, 3, stride=2, padding=1)))
                res.append(cur)
        self.mid_block_resnets_0 = rn(cur, cur)
        self.mid_block_attentions_0 = tr(cur, n - 1)
        self.mid_block_resnets_1 = rn(cur, cur)
        for i in range(n):
            stage = n - 1 - i
            skips, res = res[-(lpb + 1):], res[:-(lpb + 1)]
            for j in range(lpb + 1):
                self.add_module(f"up_blocks_{i}_resnets_{j}",
                                rn(cur + skips.pop(), ch[stage]))
                cur = ch[stage]
                if attn[stage]:
                    self.add_module(f"up_blocks_{i}_attentions_{j}",
                                    tr(cur, stage))
            if i < n - 1:
                self.add_module(f"up_blocks_{i}_upsamplers_0",
                                Holder(UpsampleConv(cur)))
        self.conv_norm_out = GroupNorm(s.norm_groups, cur, 1e-5)
        self.conv_out = Conv(cur, s.out_channels, 3, padding=1)

    def layer_names(self):
        s, n = self.spec, len(self.spec.block_out_channels)
        attn, lpb = s.attention_stages, s.layers_per_block
        names = [f"down_blocks_{i}_attentions_{j}" for i in range(n)
                 if attn[i] for j in range(lpb)]
        names.append("mid_block_attentions_0")
        names += [f"up_blocks_{i}_attentions_{j}" for i in range(n)
                  if attn[n - 1 - i] for j in range(lpb + 1)]
        return names

    def banks(self):
        """The task banks, one a transformer block in traversal order."""
        if not self.spec.task_attention:
            return []
        return [blk.task_attn for name in self.layer_names()
                for blk in getattr(self, name).blocks()]

    def forward(self, x_variants, pick, ctx, added, tap=None,
                bank_args=None):
        """x_variants [V, B, H, W, C_in] (NHWC): the distinct inputs; the
        streams are rows k*B + b of stream k, whose input is variant
        pick[k]. ctx [K*B, L, D]; added: (pooled [K*B, P], the time ids
        [N_TIME_IDS]). bank_args: per transformer block, the keyword
        arguments of its bank (or None), given the block's index. Nothing
        is shared between streams: the added conditioning reaches every
        resnet. Returns (out [K*B, H, W, C_out], taps: per block [K*B, N,
        C] or None)."""
        s = self.spec
        V, B = x_variants.shape[:2]
        idx = torch.tensor([v * B + b for v in pick for b in range(B)],
                           device=x_variants.device)
        x = x_variants.flatten(0, 1)[idx].permute(0, 3, 1, 2)
        rows = x.shape[0]
        t = torch.full((rows,), 999.0, device=x.device)
        temb = self.time_embedding(timestep_embedding(
            t, s.block_out_channels[0]))
        pooled, time_ids = added
        ids = timestep_embedding(time_ids, s.addition_time_embed_dim)
        temb = temb + self.add_embedding(torch.cat(
            [pooled, ids.reshape(1, -1).expand(rows, -1)], -1))
        taps = []
        n, attn, lpb = len(s.block_out_channels), s.attention_stages, \
            s.layers_per_block

        def layer(name, h):
            li, m = len(taps), getattr(self, name)
            out, tp = m(h, ctx, [None if bank_args is None else
                                 bank_args(li + k) for k in range(m.n)], tap)
            taps.extend(tp)
            return out

        h = self.conv_in(x)
        res = [h]
        for i in range(n):
            for j in range(lpb):
                h = getattr(self, f"down_blocks_{i}_resnets_{j}")(h, temb)
                if attn[i]:
                    h = layer(f"down_blocks_{i}_attentions_{j}", h)
                res.append(h)
            if i < n - 1:
                h = getattr(self, f"down_blocks_{i}_downsamplers_0").conv(h)
                res.append(h)
        h = self.mid_block_resnets_0(h, temb)
        h = layer("mid_block_attentions_0", h)
        h = self.mid_block_resnets_1(h, temb)
        for i in range(n):
            skips, res = res[-(lpb + 1):], res[:-(lpb + 1)]
            for j in range(lpb + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = getattr(self, f"up_blocks_{i}_resnets_{j}")(h, temb)
                if attn[n - 1 - i]:
                    h = layer(f"up_blocks_{i}_attentions_{j}", h)
            if i < n - 1:
                h = getattr(self, f"up_blocks_{i}_upsamplers_0").conv(
                    h, tuple(res[-1].shape[2:]))
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.permute(0, 2, 3, 1), taps


def specs(config: dict):
    """(main UNet spec, child spec or None, VAE spec) of a configuration
    file's `model` section."""
    m = config["model"]
    unet = dict(block_out_channels=tuple(m["unet_block_out_channels"]),
                attention_stages=tuple(m["unet_attention_stages"]),
                transformer_layers=tuple(m["unet_transformer_layers"]),
                attention_heads=tuple(m["unet_attention_heads"]),
                layers_per_block=m["unet_layers_per_block"],
                cross_attention_dim=m["cross_attention_dim"],
                addition_time_embed_dim=m["addition_time_embed_dim"],
                pooled_text_dim=m["pooled_text_dim"],
                norm_groups=m["norm_groups"])
    multi = bool(m["multi_stream"])
    main = Spec(**unet, task_attention=multi, n_attns=m["n_attns"],
                q_hidden=m["bank_q_hidden"],
                q_hidden_layers=m["bank_q_hidden_layers"],
                attn_mask_ratio=m["attn_mask_ratio"],
                attn_mask_type=m["attn_mask_type"])
    child = Spec(**unet) if multi else None
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
    m = config["model"]
    return {"text_embed_table": (N_TASKS, config["text_tokens"],
                                 m["cross_attention_dim"]),
            "text_pooled_table": (N_TASKS, m["pooled_text_dim"])}


def conditioning(config: dict, seed: int, device) -> dict:
    """The task text table [7, L, 2048], then the pooled table [7, 1280],
    both N(0, 1) in bfloat16 from the seed's "text" stream: what the two
    text encoders would give for the task prompts."""
    gen = generator(seed, "text", device)
    return {name: torch.randn(shape, generator=gen, device=device,
                              dtype=torch.bfloat16)
            for name, shape in conditioning_shapes(config).items()}


@dataclasses.dataclass
class Reference(pipeline.Reference):
    pooled: Optional[torch.Tensor] = None   # [7, P] f32

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
        f32 = {name: t.to(device=device, dtype=torch.float32)
               for name, t in conditioning.items()}
        return cls(vae=mods["vae"], unet=mods["unet"],
                   text=f32["text_embed_table"], child=mods.get("child"),
                   pooled=f32["text_pooled_table"])

    def _streams(self, unet, xv, pick, bank_args=None, tap=None):
        B = xv.shape[1]
        factor = 2 ** (len(self.vae.spec.block_out_channels) - 1)
        H, W = xv.shape[2] * factor, xv.shape[3] * factor
        time_ids = torch.tensor([H, W, 0, 0, H, W], dtype=torch.float32,
                                device=xv.device)
        # rows k*B + b
        added = (self.pooled.repeat_interleave(B, dim=0), time_ids)
        return unet(xv, pick, self.text.repeat_interleave(B, dim=0), added,
                    tap=tap, bank_args=bank_args)

    def train_inputs(self, *args, **kwargs):
        raise NotImplementedError("the SDXL configuration has no training "
                                  "cell")

    train_pred = train_inputs
