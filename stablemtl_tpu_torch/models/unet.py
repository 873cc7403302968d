"""Conditional UNet (SD2 layout) with task-feature taps.

Counterpart of `stablemtl_tpu/models/unet.py`. Module names mirror the Flax
parameter paths (`down_blocks_0_attentions_0.transformer_blocks_0...`), so
`models/convert.py` maps a Flax tree onto this state dict mechanically.

SD2 geometry: block channels (320, 640, 1280, 1280), 2 layers per block,
cross-attention dim 1024, heads (5, 10, 20, 20) of dim 64, 16 attention
layers: down0 x2, down1 x2, down2 x2, mid, up1 x3, up2 x3, up3 x3.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (Conv, Downsample, GroupNorm, ResnetBlock,
                     TimestepEmbedding, Upsample, timestep_embedding)
from .transformer import Transformer2D, _kv_project


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 12           # rgb(4) | rgb_next(4) | noise(4)
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    norm_groups: int = 32
    norm_eps: float = 1e-5
    # cross-task attention (multi-stream main UNet only)
    n_tasks: int = 7
    use_task_attention: bool = False
    task_attn_layers: str = "all"   # "all" (16 layers) | "dec" (7..15)
    n_attns: int = 4
    attn_mask_ratio: float = 0.0    # task masking, training only
    attn_mask_type: str = "attn_prob"
    dtype: str = "float32"
    # activation rematerialization: only "off" is ported (the port raises
    # otherwise); the flagship trains at batch 2 in 80 GB without it
    remat: bool = False
    remat_transformer: str = "none"
    # bf16 fast path: norms emit the compute dtype, tanh-approx gelu
    fast_math: bool = False

    @property
    def torch_dtype(self):
        return getattr(torch, self.dtype)

    @property
    def num_attn_layers(self) -> int:
        n_attn_blocks = len(self.block_out_channels) - 1
        return (self.layers_per_block * n_attn_blocks + 1
                + (self.layers_per_block + 1) * n_attn_blocks)

    def task_attn_layer_set(self) -> frozenset:
        n_down = self.layers_per_block * (len(self.block_out_channels) - 1)
        if self.task_attn_layers == "all":
            return frozenset(range(self.num_attn_layers))
        if self.task_attn_layers == "dec":
            return frozenset(range(n_down + 1, self.num_attn_layers))
        raise ValueError(self.task_attn_layers)


def tiny_unet_config(**kw) -> UNetConfig:
    """Small config for tests (same topology, tiny widths)."""
    base = dict(block_out_channels=(32, 64, 64, 64),
                attention_heads=(2, 2, 2, 2), cross_attention_dim=32,
                norm_groups=8)
    base.update(kw)
    return UNetConfig(**base)


class UNet2DConditionModel(nn.Module):
    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = self.config = config
        if cfg.remat or cfg.remat_transformer != "none":
            raise NotImplementedError(
                "remat / remat_transformer policies are not ported yet")
        dtype = cfg.torch_dtype
        ndt = dtype if cfg.fast_math else torch.float32
        ch = cfg.block_out_channels
        n_blocks = len(ch)
        temb_ch = ch[0] * 4
        active = cfg.task_attn_layer_set()
        self._ndt = ndt

        def resnet(cin, cout):
            return ResnetBlock(cin, cout, temb_ch, groups=cfg.norm_groups,
                               eps=cfg.norm_eps, dtype=dtype,
                               norm_dtype=ndt)

        def transformer(layer, c, heads):
            return Transformer2D(
                c, heads, c // heads, cfg.cross_attention_dim,
                n_tasks=cfg.n_tasks,
                use_task_attention=cfg.use_task_attention and layer in active,
                n_attns=cfg.n_attns, attn_mask_ratio=cfg.attn_mask_ratio,
                attn_mask_type=cfg.attn_mask_type,
                norm_groups=cfg.norm_groups, dtype=dtype,
                fast_math=cfg.fast_math)

        self.time_embedding = TimestepEmbedding(ch[0], temb_ch, dtype=dtype)
        self.conv_in = Conv(cfg.in_channels, ch[0], 3, padding=1)
        layer, cur, res_ch = 0, ch[0], [ch[0]]
        for i in range(n_blocks):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_blocks_{i}_resnets_{j}",
                                resnet(cur, ch[i]))
                cur = ch[i]
                if i < n_blocks - 1:
                    self.add_module(f"down_blocks_{i}_attentions_{j}",
                                    transformer(layer, cur,
                                                cfg.attention_heads[i]))
                    layer += 1
                res_ch.append(cur)
            if i < n_blocks - 1:
                self.add_module(f"down_blocks_{i}_downsamplers_0",
                                Downsample(cur, dtype=dtype))
                res_ch.append(cur)
        self.mid_block_resnets_0 = resnet(cur, cur)
        self.mid_block_attentions_0 = transformer(layer, cur,
                                                  cfg.attention_heads[-1])
        layer += 1
        self.mid_block_resnets_1 = resnet(cur, cur)
        rev_ch = list(reversed(ch))
        rev_heads = list(reversed(cfg.attention_heads))
        for i in range(n_blocks):
            n_layers = cfg.layers_per_block + 1
            skips, res_ch = res_ch[-n_layers:], res_ch[:-n_layers]
            for j in range(n_layers):
                self.add_module(f"up_blocks_{i}_resnets_{j}",
                                resnet(cur + skips.pop(), rev_ch[i]))
                cur = rev_ch[i]
                if i > 0:
                    self.add_module(f"up_blocks_{i}_attentions_{j}",
                                    transformer(layer, cur, rev_heads[i]))
                    layer += 1
            if i < n_blocks - 1:
                self.add_module(f"up_blocks_{i}_upsamplers_0",
                                Upsample(cur, dtype=dtype))
        self.conv_norm_out = GroupNorm(cfg.norm_groups, cur, eps=cfg.norm_eps)
        self.conv_out = Conv(cur, cfg.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, encoder_hidden_states,
                task_feats: Optional[Sequence] = None, main_idx=None,
                aux_idx=None, tap: Optional[str] = None, train: bool = False,
                task_kv: Optional[Sequence] = None, task_key_bias=None,
                prefix_only: bool = False, prefix_state=None,
                generator: Optional[torch.Generator] = None):
        """
        sample: [B, H, W, C_in] (NHWC); timesteps: [B] or scalar;
        encoder_hidden_states: [B, L, D].
        task_feats: 16 x [T_aux, B', N_l, C_l] child features, or task_kv:
            16 x (k_all, v_all) / None from `task_kv_tables` with
            task_key_bias [K, n_tasks]; B = K * B' rows, streams task-major.
        prefix_only: run only the conditioning-independent prefix (conv_in,
            down_blocks_0_resnets_0, the first layer's self-attention) and
            return its state dict. prefix_state: that dict with leaves
            batched to the full batch; `sample` may then be None.
        train, generator: task masking in the banks (attn_mask_ratio > 0),
            drawn from `generator` layer after layer.
        Returns (out [B, H, W, C_out], taps: 16 arrays [B, N_l, C_l] or
        Nones).
        """
        cfg = self.config
        dtype = cfg.torch_dtype
        ch = cfg.block_out_channels
        n_blocks = len(ch)
        if (prefix_only or prefix_state is not None) and (
                n_blocks < 2 or cfg.layers_per_block < 1):
            raise ValueError(
                "prefix sharing needs an attention layer in down block 0 "
                "(n_blocks >= 2 and layers_per_block >= 1)")
        if prefix_state is None:
            h = sample.permute(0, 3, 1, 2).to(dtype)
            batch, device = h.shape[0], h.device
        else:
            batch = prefix_state["res"].shape[0]
            device = prefix_state["res"].device
        timesteps = torch.as_tensor(timesteps, device=device).reshape(-1)
        timesteps = timesteps.expand(batch)
        temb = self.time_embedding(timestep_embedding(timesteps, ch[0]))
        context = encoder_hidden_states.to(dtype)
        active = cfg.task_attn_layer_set()

        taps = []

        def run_transformer(h, name, front_state=None):
            layer = len(taps)
            feats = kv = None
            if cfg.use_task_attention and layer in active:
                feats = None if task_feats is None else task_feats[layer]
                kv = None if task_kv is None else task_kv[layer]
            h, tap_feat = getattr(self, name)(
                h, context, feats, main_idx, aux_idx, tap=tap, train=train,
                task_kv=kv, task_key_bias=task_key_bias,
                front_state=front_state, generator=generator)
            taps.append(tap_feat)
            return h

        # ---- in / down ----------------------------------------------------
        h = self.conv_in(h) if prefix_state is None else prefix_state["conv"]
        res_samples = [h]
        for i in range(n_blocks):
            for j in range(cfg.layers_per_block):
                first = i == 0 and j == 0
                if first and prefix_state is not None:
                    h = run_transformer(prefix_state["res"],
                                        "down_blocks_0_attentions_0",
                                        front_state=prefix_state["front"])
                    res_samples.append(h)
                    continue
                h = getattr(self, f"down_blocks_{i}_resnets_{j}")(h, temb)
                if first and prefix_only:
                    front = self.down_blocks_0_attentions_0(
                        h, context, front_only=True)
                    return {"conv": res_samples[0], "res": h, "front": front}
                if i < n_blocks - 1:
                    h = run_transformer(h, f"down_blocks_{i}_attentions_{j}")
                res_samples.append(h)
            if i < n_blocks - 1:
                h = getattr(self, f"down_blocks_{i}_downsamplers_0")(h)
                res_samples.append(h)

        # ---- mid ----------------------------------------------------------
        h = self.mid_block_resnets_0(h, temb)
        h = run_transformer(h, "mid_block_attentions_0")
        h = self.mid_block_resnets_1(h, temb)

        # ---- up -----------------------------------------------------------
        for i in range(n_blocks):
            n_layers = cfg.layers_per_block + 1
            skips = res_samples[-n_layers:]
            res_samples = res_samples[:-n_layers]
            for j in range(n_layers):
                h = torch.cat([h, skips.pop()], dim=1)
                h = getattr(self, f"up_blocks_{i}_resnets_{j}")(h, temb)
                if i > 0:
                    h = run_transformer(h, f"up_blocks_{i}_attentions_{j}")
            if i < n_blocks - 1:
                target = tuple(res_samples[-1].shape[2:])
                out_size = (None if target == (h.shape[2] * 2,
                                               h.shape[3] * 2) else target)
                h = getattr(self, f"up_blocks_{i}_upsamplers_0")(h, out_size)

        # ---- out ----------------------------------------------------------
        h = F.silu(self.conv_norm_out(h, self._ndt)).to(dtype)
        h = self.conv_out(h)
        return h.permute(0, 2, 3, 1), taps


def task_feat_shapes(config: UNetConfig, height: int, width: int):
    """(tokens, channels) of each of the 16 attention-layer taps."""
    ch, heads = config.block_out_channels, config.attention_heads
    inner = [ch[i] // heads[i] * heads[i] for i in range(len(ch))]
    res, h, w = [], height, width
    for _ in range(4):
        res.append(h * w)
        h, w = -(-h // 2), -(-w // 2)  # pad-1 stride-2 conv: ceil
    shapes = []
    for i in range(3):
        shapes += [(res[i], inner[i])] * config.layers_per_block
    shapes += [(res[3], inner[3])]
    for i in (2, 1, 0):
        shapes += [(res[i], inner[i])] * (config.layers_per_block + 1)
    return shapes


def attention_layer_names(config: UNetConfig):
    """Module names of the attention layers in traversal order."""
    n_blocks = len(config.block_out_channels)
    names = []
    for i in range(n_blocks - 1):
        names += [f"down_blocks_{i}_attentions_{j}"
                  for j in range(config.layers_per_block)]
    names.append("mid_block_attentions_0")
    for i in range(1, n_blocks):
        names += [f"up_blocks_{i}_attentions_{j}"
                  for j in range(config.layers_per_block + 1)]
    return names


def task_kv_tables(unet: UNet2DConditionModel, taps_all):
    """The cross-task K/V tables for ALL tasks, once per layer.

    The K/V projectors read only the shared child features, so in fused
    multi-task inference they are the same for every main stream. Returns a
    list over the attention layers of (k_all, v_all) [n_tasks, B, N, C] or
    None for layers without task attention; pass as `task_kv`.
    taps_all: 16 x [n_tasks, B, N_l, C_l] (child_taps_all_tasks).
    """
    cfg = unet.config
    active = cfg.task_attn_layer_set()
    tables = []
    for li, name in enumerate(attention_layer_names(cfg)):
        if li not in active:
            tables.append(None)
            continue
        bank = getattr(unet, name).transformer_blocks_0.task_attn
        tables.append(tuple(
            _kv_project(bank, taps_all[li], None, nm, cfg.torch_dtype,
                        fast_gelu=cfg.fast_math) for nm in ("k", "v")))
    return tables


def inflate_conv_in(weight, repeat: int = 3):
    """conv_in weight [O, I, kh, kw] -> [O, I * repeat, kh, kw]: repeated
    along the input channels and scaled by 1/repeat, so the inflated conv
    gives the same output for duplicated inputs (SD2's 4-channel conv_in
    -> the 12-channel rgb | rgb_next | noise input, or 8 in 'avg' mode)."""
    return weight.repeat(1, repeat, 1, 1) / repeat
