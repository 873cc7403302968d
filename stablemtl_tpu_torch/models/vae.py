"""AutoencoderKL (Stable Diffusion 2 VAE), counterpart of
`stablemtl_tpu/models/vae.py`.

encode = encoder -> quant_conv -> latent mean (no sampling) * 0.18215;
decode = / 0.18215 -> post_quant_conv -> decoder. Channels (128, 256, 512,
512), 2 resnets per encoder block, 3 per decoder block, single-head mid
attention, GroupNorm eps 1e-6. The public functions take and return NHWC.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from .layers import Conv, Dense, GroupNorm, ResnetBlock, UpsampleConv, cast


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.18215
    dtype: str = "float32"
    fast_math: bool = False  # GroupNorms emit the compute dtype

    @property
    def torch_dtype(self):
        return getattr(torch, self.dtype)

    @property
    def norm_dtype(self):
        return self.torch_dtype if self.fast_math else torch.float32


def tiny_vae_config(**kw) -> VAEConfig:
    base = dict(block_out_channels=(16, 32, 32, 32), norm_groups=8)
    base.update(kw)
    return VAEConfig(**base)


class VAEAttention(nn.Module):
    """Single-head self-attention over spatial tokens (the mid block)."""

    def __init__(self, channels: int, norm_groups: int = 32,
                 dtype=torch.float32, norm_dtype=torch.float32):
        super().__init__()
        self.dtype, self.norm_dtype = dtype, norm_dtype
        self.group_norm = GroupNorm(norm_groups, channels, eps=1e-6)
        self.to_q = Dense(channels, channels)
        self.to_k = Dense(channels, channels)
        self.to_v = Dense(channels, channels)
        self.to_out_0 = Dense(channels, channels)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x, self.norm_dtype).permute(0, 2, 3, 1)
        h = cast(h.reshape(B, H * W, C), self.dtype)
        q, k, v = (m(h)[:, :, None, :] for m in (self.to_q, self.to_k,
                                                 self.to_v))
        h = self.to_out_0(dot_product_attention(q, k, v)[:, :, 0, :])
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


def _resnet(cfg: VAEConfig, cin: int, cout: int) -> ResnetBlock:
    return ResnetBlock(cin, cout, None, groups=cfg.norm_groups, eps=1e-6,
                       dtype=cfg.torch_dtype, norm_dtype=cfg.norm_dtype)


def _attention(cfg: VAEConfig, c: int) -> VAEAttention:
    return VAEAttention(c, cfg.norm_groups, dtype=cfg.torch_dtype,
                        norm_dtype=cfg.norm_dtype)


class Encoder(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        cfg = self.config = config
        ch = cfg.block_out_channels
        self.conv_in = Conv(cfg.in_channels, ch[0], 3, padding=1)
        cur = ch[0]
        for i in range(len(ch)):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_blocks_{i}_resnets_{j}",
                                _resnet(cfg, cur, ch[i]))
                cur = ch[i]
            if i < len(ch) - 1:
                # SD VAE downsample: stride-2 conv after (0,1)x(0,1) padding
                self.add_module(f"down_blocks_{i}_downsamplers_0_conv",
                                Conv(cur, cur, 3, stride=2))
        self.mid_block_resnets_0 = _resnet(cfg, cur, cur)
        self.mid_block_attentions_0 = _attention(cfg, cur)
        self.mid_block_resnets_1 = _resnet(cfg, cur, cur)
        self.conv_norm_out = GroupNorm(cfg.norm_groups, cur, eps=1e-6)
        self.conv_out = Conv(cur, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        """x [B, C, H, W] -> moments [B, 2*latent, h, w]."""
        cfg = self.config
        h = self.conv_in(x.to(cfg.torch_dtype))
        for i in range(len(cfg.block_out_channels)):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_blocks_{i}_resnets_{j}")(h)
            if i < len(cfg.block_out_channels) - 1:
                h = getattr(self, f"down_blocks_{i}_downsamplers_0_conv")(
                    F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block_resnets_0(h)
        h = self.mid_block_attentions_0(h)
        h = self.mid_block_resnets_1(h)
        h = F.silu(self.conv_norm_out(h, cfg.norm_dtype)).to(cfg.torch_dtype)
        return self.conv_out(h)


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        cfg = self.config = config
        rev_ch = list(reversed(cfg.block_out_channels))
        dtype = cfg.torch_dtype
        self.conv_in = Conv(cfg.latent_channels, rev_ch[0], 3, padding=1)
        self.mid_block_resnets_0 = _resnet(cfg, rev_ch[0], rev_ch[0])
        self.mid_block_attentions_0 = _attention(cfg, rev_ch[0])
        self.mid_block_resnets_1 = _resnet(cfg, rev_ch[0], rev_ch[0])
        cur = rev_ch[0]
        for i in range(len(rev_ch)):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_blocks_{i}_resnets_{j}",
                                _resnet(cfg, cur, rev_ch[i]))
                cur = rev_ch[i]
            if i < len(rev_ch) - 1:
                self.add_module(f"up_blocks_{i}_upsamplers_0_conv",
                                UpsampleConv(cur, cur, dtype=dtype))
        self.conv_norm_out = GroupNorm(cfg.norm_groups, cur, eps=1e-6)
        self.conv_out = Conv(cur, cfg.out_channels, 3, padding=1)

    def forward(self, z):
        """z [B, latent, h, w] -> image [B, C, H, W]."""
        cfg = self.config
        h = self.conv_in(z.to(cfg.torch_dtype))
        h = self.mid_block_resnets_0(h)
        h = self.mid_block_attentions_0(h)
        h = self.mid_block_resnets_1(h)
        n = len(cfg.block_out_channels)
        for i in range(n):
            for j in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_blocks_{i}_resnets_{j}")(h)
            if i < n - 1:
                h = getattr(self, f"up_blocks_{i}_upsamplers_0_conv")(h)
        h = F.silu(self.conv_norm_out(h, cfg.norm_dtype)).to(cfg.torch_dtype)
        return self.conv_out(h)


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        lat = config.latent_channels
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = Conv(2 * lat, 2 * lat, 1)
        self.post_quant_conv = Conv(lat, lat, 1)

    def encode(self, x):
        """Image [-1, 1] NHWC -> scaled latent mean NHWC (no sampling)."""
        x = x.permute(0, 3, 1, 2).to(self.config.torch_dtype)
        moments = self.quant_conv(self.encoder(x))
        mean = moments[:, :self.config.latent_channels]
        return (mean * self.config.scaling_factor).permute(0, 2, 3, 1)

    def decode(self, latent):
        """Scaled latent NHWC -> image NHWC."""
        z = latent.permute(0, 3, 1, 2).to(self.config.torch_dtype)
        z = z / self.config.scaling_factor
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)
