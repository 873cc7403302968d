"""Shared building blocks of the UNet and the VAE.

Modules compute in NCHW (the task axis is folded into the batch by the
callers). Each mirrors the dtype rules of its Flax counterpart in
`stablemtl_tpu/models/layers.py`: a Dense or Conv casts its input and
parameters to the compute dtype; a norm computes its statistics in f32 and
emits `norm_dtype` (f32, or the compute dtype under fast_math).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.geglu import geglu_proj
from ..ops.phase_upsample import upsample2x_conv3x3
from ..parallel.tensor_parallel import copy_to_model, row_linear


def cast(t, dtype):
    """t in `dtype`: t itself where it has it already. The same as
    `t.to(dtype)`, but a trace (`torch.export`) records no node for it: the
    layers below cast every weight and norm input, and at one dtype those
    no-op casts, each with a metadata assert, were half an exported
    graph's nodes and of its trace time."""
    return t if t is None or t.dtype == dtype else t.to(dtype)


class Dense(nn.Linear):
    """Linear layer computing in its input's dtype (weight [out, in])."""

    def forward(self, x):
        return F.linear(x, cast(self.weight, x.dtype),
                        cast(self.bias, x.dtype))


class Conv(nn.Conv2d):
    """Conv2d computing in its input's dtype (weight OIHW)."""

    def forward(self, x):
        return self._conv_forward(x, cast(self.weight, x.dtype),
                                  cast(self.bias, x.dtype))


class GroupNorm(nn.GroupNorm):
    """GroupNorm with f32 statistics, emitting `out_dtype`."""

    def forward(self, x, out_dtype=torch.float32):
        f32 = torch.float32
        return cast(F.group_norm(cast(x, f32), self.num_groups,
                                 cast(self.weight, f32),
                                 cast(self.bias, f32), self.eps), out_dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis (Flax default eps 1e-6), f32 statistics,
    emitting `out_dtype`."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x, out_dtype=torch.float32):
        f32 = torch.float32
        return cast(F.layer_norm(cast(x, f32), self.normalized_shape,
                                 cast(self.weight, f32), cast(self.bias, f32),
                                 self.eps), out_dtype)


def timestep_embedding(timesteps, dim: int, flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: int = 10000):
    """Sinusoidal timestep embedding (cos first). [B] -> [B, dim] f32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """linear -> SiLU -> linear (320 -> 1280 -> 1280 for SD2)."""

    def __init__(self, in_dim: int, time_embed_dim: int,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.linear_1 = Dense(in_dim, time_embed_dim)
        self.linear_2 = Dense(time_embed_dim, time_embed_dim)

    def forward(self, t_emb):
        return self.linear_2(F.silu(self.linear_1(cast(t_emb, self.dtype))))


class ResnetBlock(nn.Module):
    """GroupNorm -> SiLU -> conv -> (+temb) -> GroupNorm -> SiLU -> conv
    (+ skip). eps is 1e-5 in the UNet, 1e-6 in the VAE."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, groups: int = 32,
                 eps: float = 1e-5, dtype=torch.float32,
                 norm_dtype=torch.float32):
        super().__init__()
        self.dtype, self.norm_dtype = dtype, norm_dtype
        self.norm1 = GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = Conv(in_channels, out_channels, 3, padding=1)
        if temb_channels is not None:
            self.time_emb_proj = Dense(temb_channels, out_channels)
        self.norm2 = GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = Conv(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = Conv(in_channels, out_channels, 1)

    def forward(self, x, temb=None):
        h = cast(F.silu(self.norm1(x, self.norm_dtype)), self.dtype)
        h = self.conv1(h)
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = cast(F.silu(self.norm2(h, self.norm_dtype)), self.dtype)
        h = self.conv2(h)
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(cast(x, self.dtype))
        return x + h


class Downsample(nn.Module):
    """Stride-2 3x3 conv."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(cast(x, self.dtype))


class UpsampleConv(nn.Module):
    """The 3x3 conv applied after nearest upsampling. The standard 2x path is
    one stride-2 transposed conv on the low-res input
    (ops/phase_upsample.py); an irregular target size (odd skip sizes) takes
    a literal nearest gather with torch's index rule floor(i * in / out),
    then the conv."""

    def __init__(self, in_channels: int, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x, output_size=None):
        x = cast(x, self.dtype)
        h, w = x.shape[2:]
        if output_size is None or tuple(output_size) == (2 * h, 2 * w):
            return upsample2x_conv3x3(x, self.weight, self.bias)
        dev = x.device
        rows = torch.arange(output_size[0], device=dev) * h // output_size[0]
        cols = torch.arange(output_size[1], device=dev) * w // output_size[1]
        x = x[:, :, rows][:, :, :, cols]
        return F.conv2d(x, cast(self.weight, self.dtype),
                        cast(self.bias, self.dtype), padding=1)


class Upsample(nn.Module):
    """Nearest 2x + 3x3 conv."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.conv = UpsampleConv(channels, channels, dtype=dtype)

    def forward(self, x, output_size=None):
        return self.conv(x, output_size)


class GEGLU(nn.Module):
    """proj -> split(value, gate) -> value * gelu(gate). Exact erf gelu, or
    the tanh approximation under fast_gelu. The projection's parameters
    keep the Dense's names (net_0.proj.weight/bias); the compute goes
    through ops.geglu.geglu_proj (plain, or the fused kernel K6 under
    STABLEMTL_FUSED_GEGLU)."""

    def __init__(self, dim: int, inner_dim: int, fast_gelu: bool = False):
        super().__init__()
        self.fast_gelu = fast_gelu
        self.proj = Dense(dim, inner_dim * 2)

    def forward(self, x):
        return geglu_proj(x, cast(self.proj.weight, x.dtype),
                          cast(self.proj.bias, x.dtype), self.fast_gelu)


class FeedForward(nn.Module):
    """GEGLU feed-forward, 4x expansion. Under tensor parallelism (`tp`,
    the mesh, set by `parallel.tensor_parallel.shard_unet`) the GEGLU runs
    on this rank's value and gate rows, `net_2` on its input slice, and
    the partial sums are reduced over the model group."""

    def __init__(self, dim: int, mult: int = 4, fast_gelu: bool = False):
        super().__init__()
        self.net_0 = GEGLU(dim, dim * mult, fast_gelu=fast_gelu)
        self.net_2 = Dense(dim * mult, dim)
        self.tp = None

    def forward(self, x):
        if self.tp is None:
            return self.net_2(self.net_0(x))
        return row_linear(self.net_2, self.net_0(copy_to_model(x, self.tp)),
                          self.tp)
