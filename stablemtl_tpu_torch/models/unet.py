"""Conditional UNet (SD2 and SDXL layouts) with task-feature taps.

Counterpart of `stablemtl_tpu/models/unet.py`. Module names mirror the Flax
parameter paths (`down_blocks_0_attentions_0.transformer_blocks_0...`), so
`models/convert.py` maps a Flax tree onto this state dict mechanically.

SD2 geometry (the defaults): block channels (320, 640, 1280, 1280), 2
layers per block, cross-attention dim 1024, heads (5, 10, 20, 20) of dim
64, 16 attention layers of one transformer block: down0 x2, down1 x2,
down2 x2, mid, up1 x3, up2 x3, up3 x3.

SDXL geometry (`factory.model_configs("sdxl", ...)`): channels (320, 640,
1280), no attention in the 320 stage, 2 transformer blocks in each 640
attention layer and 10 in each 1280 layer and the mid block, cross-attention
dim 2048, and the text-time added conditioning (`add_embedding`). Every
transformer block has its own tap and, in the multi-stream main UNet, its
own task bank: 70 in all. The taps, banks and K/V tables are counted over
blocks in traversal order (`attention_layer_names`).

Activation recompute in training, as the JAX package's `nn.remat`:
`remat` recomputes each ResnetBlock whole in the backward;
`remat_transformer` "full" each attention layer whole, "dots" each
attention layer but for the outputs of its matrix products (mm, addmm, bmm,
baddbmm), which are kept, as `jax.checkpoint_policies.dots_saveable` does.
The flash calls are not such products: K3 runs again in the recompute. A
recomputed layer draws its task masks again from the explicit generator
(`remat_call`), so it replays the generator state the forward started from
and then restores the state the stream had reached.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as tcp
from torch import nn

from .layers import (Conv, Downsample, GroupNorm, ResnetBlock,
                     TimestepEmbedding, Upsample, timestep_embedding)
from .transformer import Transformer2D, _kv_project

# SDXL's time ids: original (H, W), crop (top, left), target (H, W)
N_TIME_IDS = 6


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
    # activation recompute in training: `remat` each ResnetBlock whole;
    # `remat_transformer` each attention layer, "none" | "full" | "dots"
    # (keep the matrix products' outputs, recompute the rest)
    remat: bool = False
    remat_transformer: str = "none"
    # bf16 fast path: norms emit the compute dtype, tanh-approx gelu
    fast_math: bool = False

    @property
    def torch_dtype(self):
        return getattr(torch, self.dtype)

    @property
    def stage_attention(self) -> Tuple[bool, ...]:
        """Whether each stage's layers attend: all but the last."""
        n = len(self.block_out_channels)
        return tuple(i < n - 1 for i in range(n))

    @property
    def stage_blocks(self) -> Tuple[int, ...]:
        """The transformer blocks of each stage's attention layers: one."""
        return (1,) * len(self.block_out_channels)

    @property
    def has_added_cond(self) -> bool:
        return False

    @property
    def prefix_shareable(self) -> bool:
        """Whether conv_in -> the first self-attention is free of the
        conditioning: it needs an attention layer in stage 0, and no added
        conditioning (that reaches every resnet through the timestep
        embedding)."""
        return (self.stage_attention[0] and self.layers_per_block >= 1
                and not self.has_added_cond)

    @property
    def num_attn_layers(self) -> int:
        """The transformer blocks: one tap, and one bank, each."""
        return sum(n for _, _, n in attention_layers(self))

    def task_attn_layer_set(self) -> frozenset:
        """The blocks with a task bank: "all", or "dec" those of the up
        stages."""
        total = self.num_attn_layers
        if self.task_attn_layers == "all":
            return frozenset(range(total))
        if self.task_attn_layers == "dec":
            first_up = sum(n for name, _, n in attention_layers(self)
                           if not name.startswith("up_"))
            return frozenset(range(first_up, total))
        raise ValueError(self.task_attn_layers)


@dataclasses.dataclass(frozen=True)
class SDXLUNetConfig(UNetConfig):
    """A UNetConfig with attention placed, and transformer blocks stacked,
    per stage, and the text-time added conditioning: the SDXL layout (the
    defaults; `factory.model_configs("sdxl", ...)`). Apart from
    UNetConfig, whose fields are the JAX package's, field for field."""
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    attention_heads: Tuple[int, ...] = (5, 10, 20)
    cross_attention_dim: int = 2048
    # per stage: whether its layers attend, and the transformer blocks of
    # each of its attention layers; the up stages take both in reverse,
    # the mid block the last stage's blocks
    attention_stages: Tuple[bool, ...] = (False, True, True)
    transformer_layers: Tuple[int, ...] = (1, 2, 10)
    # a pooled text embedding of `pooled_text_dim` and N_TIME_IDS time
    # ids, each a sinusoid of `addition_time_embed_dim`, through
    # `add_embedding` into the timestep embedding
    addition_time_embed_dim: int = 256
    pooled_text_dim: int = 1280

    @property
    def stage_attention(self) -> Tuple[bool, ...]:
        return tuple(self.attention_stages)

    @property
    def stage_blocks(self) -> Tuple[int, ...]:
        return tuple(self.transformer_layers)

    @property
    def has_added_cond(self) -> bool:
        return self.addition_time_embed_dim > 0


def attention_layers(config) -> list:
    """(module name, stage, transformer blocks) of each attention layer of
    a UNet config in traversal order. A config without `stage_attention`
    and `stage_blocks` (the JAX package's) has SD2's placement, one block
    a layer."""
    n = len(config.block_out_channels)
    attn = getattr(config, "stage_attention",
                   tuple(i < n - 1 for i in range(n)))
    blocks = getattr(config, "stage_blocks", (1,) * n)
    lpb = config.layers_per_block
    layers = [(f"down_blocks_{i}_attentions_{j}", i, blocks[i])
              for i in range(n) if attn[i] for j in range(lpb)]
    layers.append(("mid_block_attentions_0", n - 1, blocks[-1]))
    layers += [(f"up_blocks_{n - 1 - s}_attentions_{j}", s, blocks[s])
               for s in reversed(range(n)) if attn[s]
               for j in range(lpb + 1)]
    return layers


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
        if cfg.remat_transformer not in REMAT_POLICIES:
            raise ValueError(f"remat_transformer {cfg.remat_transformer!r} "
                             f"is not one of {REMAT_POLICIES}")
        dtype = cfg.torch_dtype
        ndt = dtype if cfg.fast_math else torch.float32
        ch = cfg.block_out_channels
        n_blocks = len(ch)
        temb_ch = ch[0] * 4
        active = cfg.task_attn_layer_set()
        attn, blocks = cfg.stage_attention, cfg.stage_blocks
        self._ndt = ndt

        def resnet(cin, cout):
            return ResnetBlock(cin, cout, temb_ch, groups=cfg.norm_groups,
                               eps=cfg.norm_eps, dtype=dtype,
                               norm_dtype=ndt)

        def transformer(layer, c, stage):
            n = blocks[stage]
            on = [cfg.use_task_attention and li in active
                  for li in range(layer, layer + n)]
            heads = cfg.attention_heads[stage]
            return Transformer2D(
                c, heads, c // heads, cfg.cross_attention_dim,
                n_tasks=cfg.n_tasks,
                use_task_attention=on,
                n_attns=cfg.n_attns, attn_mask_ratio=cfg.attn_mask_ratio,
                attn_mask_type=cfg.attn_mask_type,
                norm_groups=cfg.norm_groups, dtype=dtype,
                fast_math=cfg.fast_math, n_blocks=n)

        self.time_embedding = TimestepEmbedding(ch[0], temb_ch, dtype=dtype)
        if cfg.has_added_cond:
            self.add_embedding = TimestepEmbedding(
                cfg.pooled_text_dim
                + N_TIME_IDS * cfg.addition_time_embed_dim, temb_ch,
                dtype=dtype)
        self.conv_in = Conv(cfg.in_channels, ch[0], 3, padding=1)
        layer, cur, res_ch = 0, ch[0], [ch[0]]
        for i in range(n_blocks):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_blocks_{i}_resnets_{j}",
                                resnet(cur, ch[i]))
                cur = ch[i]
                if attn[i]:
                    self.add_module(f"down_blocks_{i}_attentions_{j}",
                                    transformer(layer, cur, i))
                    layer += blocks[i]
                res_ch.append(cur)
            if i < n_blocks - 1:
                self.add_module(f"down_blocks_{i}_downsamplers_0",
                                Downsample(cur, dtype=dtype))
                res_ch.append(cur)
        self.mid_block_resnets_0 = resnet(cur, cur)
        self.mid_block_attentions_0 = transformer(layer, cur, n_blocks - 1)
        layer += blocks[-1]
        self.mid_block_resnets_1 = resnet(cur, cur)
        rev_ch = list(reversed(ch))
        for i in range(n_blocks):
            n_layers = cfg.layers_per_block + 1
            stage = n_blocks - 1 - i
            skips, res_ch = res_ch[-n_layers:], res_ch[:-n_layers]
            for j in range(n_layers):
                self.add_module(f"up_blocks_{i}_resnets_{j}",
                                resnet(cur + skips.pop(), rev_ch[i]))
                cur = rev_ch[i]
                if attn[stage]:
                    self.add_module(f"up_blocks_{i}_attentions_{j}",
                                    transformer(layer, cur, stage))
                    layer += blocks[stage]
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
                generator: Optional[torch.Generator] = None,
                text_embeds=None, time_ids=None):
        """
        sample: [B, H, W, C_in] (NHWC); timesteps: [B] or scalar;
        encoder_hidden_states: [B, L, D].
        task_feats: one [T_aux, B', N_l, C_l] of child features a
            transformer block (16 for SD2, 70 for SDXL), or task_kv: one
            (k_all, v_all) / None a block from `task_kv_tables` with
            task_key_bias [K, n_tasks]; B = K * B' rows, streams task-major.
        text_embeds [B, pooled_text_dim], time_ids [N_TIME_IDS] or [B,
            N_TIME_IDS]: the added conditioning, for a config with it.
        prefix_only: run only the conditioning-independent prefix (conv_in,
            down_blocks_0_resnets_0, the first layer's self-attention) and
            return its state dict. prefix_state: that dict with leaves
            batched to the full batch; `sample` may then be None. Only for
            a config that is `prefix_shareable`.
        train, generator: task masking in the banks (attn_mask_ratio > 0),
            drawn from `generator` block after block.
        Returns (out [B, H, W, C_out], taps: one [B, N_l, C_l] or None a
        transformer block).
        """
        cfg = self.config
        dtype = cfg.torch_dtype
        ch = cfg.block_out_channels
        n_blocks = len(ch)
        attn = cfg.stage_attention
        if (prefix_only or prefix_state is not None) and \
                not cfg.prefix_shareable:
            raise ValueError(
                "prefix sharing needs an attention layer in down block 0 "
                "and no added conditioning")
        if prefix_state is None:
            h = sample.permute(0, 3, 1, 2).to(dtype)
            batch, device = h.shape[0], h.device
        else:
            batch = prefix_state["res"].shape[0]
            device = prefix_state["res"].device
        timesteps = torch.as_tensor(timesteps, device=device).reshape(-1)
        timesteps = timesteps.expand(batch)
        temb = self.time_embedding(timestep_embedding(timesteps, ch[0]))
        if cfg.has_added_cond:
            temb = temb + self._added_embedding(text_embeds, time_ids, batch)
        context = encoder_hidden_states.to(dtype)
        active = cfg.task_attn_layer_set()

        taps = []
        # recompute only where a backward will run
        grad = torch.is_grad_enabled()
        layer_policy = cfg.remat_transformer if grad else "none"

        def resnet(name, h):
            block = getattr(self, name)
            if cfg.remat and grad:
                return tcp.checkpoint(block, h, temb, use_reentrant=False)
            return block(h, temb)

        def of_block(seq, li):
            on = cfg.use_task_attention and li in active
            return seq[li] if on and seq is not None else None

        def run_transformer(h, name, front_state=None):
            layer = len(taps)
            module = getattr(self, name)
            n = module.n_blocks
            # a one-block layer takes its block's own, several a list
            feats, kv = ([of_block(seq, li) for li in range(layer, layer + n)]
                         for seq in (task_feats, task_kv))
            if n == 1:
                feats, kv = feats[0], kv[0]
            call = functools.partial(
                module, tap=tap, train=train, task_kv=kv,
                task_key_bias=task_key_bias, front_state=front_state,
                generator=generator)
            args = (h, context, feats, main_idx, aux_idx)
            h, tap_feat = (call(*args) if layer_policy == "none" else
                           remat_call(call, layer_policy, generator, *args))
            taps.extend([tap_feat] if n == 1 else tap_feat)
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
                h = resnet(f"down_blocks_{i}_resnets_{j}", h)
                if first and prefix_only:
                    front = self.down_blocks_0_attentions_0(
                        h, context, front_only=True)
                    return {"conv": res_samples[0], "res": h, "front": front}
                if attn[i]:
                    h = run_transformer(h, f"down_blocks_{i}_attentions_{j}")
                res_samples.append(h)
            if i < n_blocks - 1:
                h = getattr(self, f"down_blocks_{i}_downsamplers_0")(h)
                res_samples.append(h)

        # ---- mid ----------------------------------------------------------
        h = resnet("mid_block_resnets_0", h)
        h = run_transformer(h, "mid_block_attentions_0")
        h = resnet("mid_block_resnets_1", h)

        # ---- up -----------------------------------------------------------
        for i in range(n_blocks):
            n_layers = cfg.layers_per_block + 1
            skips = res_samples[-n_layers:]
            res_samples = res_samples[:-n_layers]
            for j in range(n_layers):
                h = torch.cat([h, skips.pop()], dim=1)
                h = resnet(f"up_blocks_{i}_resnets_{j}", h)
                if attn[n_blocks - 1 - i]:
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

    def _added_embedding(self, text_embeds, time_ids, batch: int):
        """SDXL's text-time conditioning: add_embedding([pooled text |
        sinusoids of the time ids]), [batch, temb]; the time ids are one
        row for every sample, or one row a sample."""
        cfg = self.config
        if text_embeds is None or time_ids is None:
            raise ValueError("this UNet's added conditioning needs "
                             "text_embeds and time_ids")
        ids = torch.as_tensor(time_ids, device=text_embeds.device)
        ids = ids.reshape(-1, N_TIME_IDS)
        emb = timestep_embedding(ids.reshape(-1), cfg.addition_time_embed_dim)
        emb = emb.reshape(ids.shape[0], -1).expand(batch, -1)
        return self.add_embedding(torch.cat([text_embeds.float(), emb], -1))


REMAT_POLICIES = ("none", "full", "dots")
# the matrix products whose outputs "dots" keeps (F.linear, matmul and
# einsum reach the dispatcher as these)
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (tcp.CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else tcp.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_call(fn, policy: str, generator: Optional[torch.Generator],
               *args):
    """fn(*args) under non-reentrant activation checkpointing: "full"
    recomputes all of it in the backward, "dots" all but the matrix
    products' outputs (selective checkpointing). torch's own RNG stash
    covers only the default generators, so the state of `generator` is
    taken here on entry; the recompute replays it and then puts back the
    state the stream had reached, so the recompute draws what the forward
    drew and the stream goes on as without recompute."""
    if generator is not None:
        start = generator.get_state()
        forward = fn
        calls = 0

        def fn(*a):
            nonlocal calls
            calls += 1
            if calls == 1:
                return forward(*a)
            reached = generator.get_state()
            generator.set_state(start)
            try:
                return forward(*a)
            finally:  # the recompute may stop early, by an exception
                generator.set_state(reached)

    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            tcp.create_selective_checkpoint_contexts, _save_dots)
    elif policy != "full":
        raise ValueError(f"remat policy {policy!r}")
    return tcp.checkpoint(fn, *args, use_reentrant=False, **kw)


def task_feat_shapes(config: UNetConfig, height: int, width: int):
    """(tokens, channels) of each transformer block's tap, in traversal
    order (16 for SD2, 70 for SDXL)."""
    ch, heads = config.block_out_channels, config.attention_heads
    inner = [ch[i] // heads[i] * heads[i] for i in range(len(ch))]
    res, h, w = [], height, width
    for _ in ch:
        res.append(h * w)
        h, w = -(-h // 2), -(-w // 2)  # pad-1 stride-2 conv: ceil
    return [(res[stage], inner[stage])
            for _, stage, n in attention_layers(config) for _ in range(n)]


def attention_layer_names(config: UNetConfig):
    """Module paths of the transformer blocks in traversal order
    (`<attention layer>.transformer_blocks_<k>`): one tap, bank and K/V
    table each."""
    return [f"{name}.transformer_blocks_{k}"
            for name, _, n in attention_layers(config) for k in range(n)]


def task_kv_tables(unet: UNet2DConditionModel, taps_all):
    """The cross-task K/V tables for ALL tasks, once per transformer block.

    The K/V projectors read only the shared child features, so in fused
    multi-task inference they are the same for every main stream. Returns a
    list over the blocks of (k_all, v_all) [n_tasks, B, N, C] or None for
    blocks without task attention; pass as `task_kv`.
    taps_all: one [n_tasks, B, N_l, C_l] a block (child_taps_all_tasks).
    """
    cfg = unet.config
    active = cfg.task_attn_layer_set()
    tables = []
    for li, name in enumerate(attention_layer_names(cfg)):
        if li not in active:
            tables.append(None)
            continue
        bank = unet.get_submodule(name).task_attn
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
