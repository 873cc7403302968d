"""A plain float32 copy of the StableMTL model math: SD2's conditional
UNet with the cross-task attention banks, and SD2's VAE.

It imports nothing of the program. Parameter names follow the program's
state dicts, so one set of seeded weights loads into both by name.
Departures from the program, all in the order or form of the same math:
plain softmax attention (no flash kernels, no fast softmax), plain GEGLU,
nearest upsampling followed by the 3x3 convolution (the program folds the
two into one transposed convolution), no bfloat16 anywhere, and every
product through `precision` (float32, or the fp8 control).

The UNet's forward shares the conditioning-free prefix (conv_in, the first
resnet, the first layer's self-attention) between the streams of one
input, and the banks' key and value tables between the main streams: the
same numbers as computing them per stream.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .precision import (conv2d, einsum, linear, matmul, note_attention,
                        upsample_conv)

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class UNetSpec:
    in_channels: int = 12
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    norm_groups: int = 32
    n_tasks: int = 7
    task_attention: bool = False
    n_attns: int = 4
    q_hidden: int = 640
    q_hidden_layers: int = 2
    attn_mask_ratio: float = 0.0
    attn_mask_type: str = "attn_prob"


@dataclasses.dataclass(frozen=True)
class VAESpec:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.18215


def _p(*shape):
    return nn.Parameter(torch.empty(*shape))


class Linear(nn.Module):
    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.weight = _p(cout, cin)
        self.bias = _p(cout) if bias else None

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class Conv(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0):
        super().__init__()
        self.weight = _p(cout, cin, k, k)
        self.bias = _p(cout)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride, self.padding)


class GroupNorm(nn.Module):
    def __init__(self, groups, c, eps):
        super().__init__()
        self.weight, self.bias = _p(c), _p(c)
        self.groups, self.eps = groups, eps

    def forward(self, x):
        return F.group_norm(x, self.groups, self.weight, self.bias, self.eps)


class LayerNorm(nn.Module):
    def __init__(self, c, eps=1e-6):
        super().__init__()
        self.weight, self.bias = _p(c), _p(c)
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias,
                            self.eps)


def timestep_embedding(t, dim: int):
    """Sinusoidal embedding, cos first, no frequency shift."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.linear_1, self.linear_2 = Linear(cin, cout), Linear(cout, cout)

    def forward(self, t):
        return self.linear_2(F.silu(self.linear_1(t)))


class ResnetBlock(nn.Module):
    def __init__(self, cin, cout, temb=None, groups=32, eps=1e-5):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps)
        self.conv1 = Conv(cin, cout, 3, padding=1)
        if temb is not None:
            self.time_emb_proj = Linear(temb, cout)
        self.norm2 = GroupNorm(groups, cout, eps)
        self.conv2 = Conv(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = Conv(cin, cout, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class UpsampleConv(nn.Module):
    """Nearest upsampling to `size` (2x by default), then a 3x3 conv."""

    def __init__(self, c):
        super().__init__()
        self.weight, self.bias = _p(c, c, 3, 3), _p(c)

    def forward(self, x, size=None):
        return upsample_conv(x, self.weight, self.bias, size)


class Holder(nn.Module):
    """A module that only names its child `conv` (the program's
    `Downsample` and `Upsample`)."""

    def __init__(self, conv):
        super().__init__()
        self.conv = conv


def attention(q, k, v, heads):
    """Plain multi-head softmax attention on [B, S, heads * d]."""
    B, S, C = q.shape
    d = C // heads
    note_attention(B * heads, S, k.shape[1], d, q.requires_grad)
    qh, kh, vh = (t.reshape(B, -1, heads, d).transpose(1, 2)
                  for t in (q, k, v))
    probs = torch.softmax(matmul(qh, kh.transpose(-1, -2)) * d ** -0.5, -1)
    return matmul(probs, vh).transpose(1, 2).reshape(B, S, C)


class Attention(nn.Module):
    def __init__(self, dim, heads, context_dim=None):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(context_dim or dim, dim, bias=False)
        self.to_v = Linear(context_dim or dim, dim, bias=False)
        self.to_out_0 = Linear(dim, dim)

    def forward(self, x, context=None):
        c = x if context is None else context
        return self.to_out_0(attention(self.to_q(x), self.to_k(c),
                                       self.to_v(c), self.heads))


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = Linear(dim, 2 * inner)

    def forward(self, x):
        h, g = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(g)


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net_0 = GEGLU(dim, 4 * dim)
        self.net_2 = Linear(4 * dim, dim)

    def forward(self, x):
        return self.net_2(self.net_0(x))


def _bank_ln(x, scale, bias, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], None, None, eps) * scale + bias


class TaskAttentionBank(nn.Module):
    """Cross-task attention of one layer: per-task K, V and Q projectors
    stacked over the task axis; each pixel of a main stream attends, with
    `n_attns` heads, over one token per auxiliary task."""

    def __init__(self, dim, spec: UNetSpec):
        super().__init__()
        C, T, Ch = dim, spec.n_tasks, dim // 2
        self.n_attns = spec.n_attns
        self.ratio, self.kind = spec.attn_mask_ratio, spec.attn_mask_type
        for nm in ("k", "v"):
            setattr(self, f"task_norm_{nm}_scale", _p(T, C))
            setattr(self, f"task_norm_{nm}_bias", _p(T, C))
            setattr(self, f"task_to_{nm}_fc1_kernel", _p(T, C, Ch))
            setattr(self, f"task_to_{nm}_fc1_bias", _p(T, Ch))
            setattr(self, f"task_to_{nm}_fc2_kernel", _p(T, Ch, C))
            setattr(self, f"task_to_{nm}_fc2_bias", _p(T, C))
        self.task_norm_q_scale, self.task_norm_q_bias = _p(T, C), _p(T, C)
        dims = [C] + [spec.q_hidden] * (spec.q_hidden_layers + 1) + [C]
        self.n_q = len(dims) - 1
        for li in range(self.n_q):
            setattr(self, f"task_to_q_net_{2 * li}_kernel",
                    _p(T, dims[li], dims[li + 1]))
            setattr(self, f"task_to_q_net_{2 * li}_bias", _p(T, dims[li + 1]))
        self.to_out_task_kernel, self.to_out_task_bias = _p(C, C), _p(C)

    def kv(self, feats, tasks, nm):
        """K or V of the tasks `tasks` ([T] long) from their child features
        [T, B, N, C]: LN_t -> C -> C/2 -> gelu -> C."""
        g = lambda name: getattr(self, name)[tasks]  # noqa: E731
        T, B, N, C = feats.shape
        x = _bank_ln(feats, g(f"task_norm_{nm}_scale")[:, None, None],
                     g(f"task_norm_{nm}_bias")[:, None, None])
        x = x.reshape(T, B * N, C)
        x = matmul(x, g(f"task_to_{nm}_fc1_kernel")) \
            + g(f"task_to_{nm}_fc1_bias")[:, None]
        x = matmul(F.gelu(x), g(f"task_to_{nm}_fc2_kernel")) \
            + g(f"task_to_{nm}_fc2_bias")[:, None]
        return x.reshape(T, B, N, C)

    def forward(self, hidden, k_all, v_all, main_idx, key_bias,
                masker=None):
        """hidden [K*B, N, C], the K streams task-major; k_all, v_all [T, B,
        N, C]; main_idx [K]; key_bias [K, T] (-1e9 on keys a stream does
        not attend). masker: in training, scores [K, B, N, h, T] -> the
        task mask [K, T] added to them (`draw` says how it is drawn), or
        None. Returns the bank's output [K*B, N, C]."""
        T, B = k_all.shape[:2]
        R, N, C = hidden.shape
        K = R // B
        q = _bank_ln(hidden.reshape(K, B * N, C),
                     self.task_norm_q_scale[main_idx][:, None],
                     self.task_norm_q_bias[main_idx][:, None])
        for li in range(self.n_q):
            q = matmul(q, getattr(self, f"task_to_q_net_{2 * li}_kernel")[
                main_idx]) + getattr(self, f"task_to_q_net_{2 * li}_bias")[
                    main_idx][:, None]
            if li < self.n_q - 1:
                q = F.gelu(q)
        h, d = self.n_attns, C // self.n_attns
        qh = q.reshape(K, B, N, h, d)
        kh, vh = (t.reshape(T, B, N, h, d) for t in (k_all, v_all))
        scores = einsum("kbnhd,tbnhd->kbnht", qh, kh) * d ** -0.5
        scores = scores + key_bias[:, None, None, None, :]
        if masker is not None:
            scores = scores + masker(scores)[:, None, None, None, :]
        probs = torch.softmax(scores, dim=-1)
        out = einsum("kbnht,tbnhd->kbnhd", probs, vh).reshape(R, N, C)
        return matmul(out, self.to_out_task_kernel) + self.to_out_task_bias

    def draw(self, scores, generator):
        """The training regularizer's draw, type attn_prob: a gate per
        stream (masked with probability `ratio`), then one key per stream
        drawn with probability its mean attention over the batch, pixels
        and heads, as argmax(p / E) with E ~ Exp(1) a key. Returns (gate
        [K] bool, pick [K] long, margin [K]: how far the best p / E lies
        above the second, relative: a pick that rounding can turn where
        it is small)."""
        if self.kind != "attn_prob":
            raise NotImplementedError(self.kind)
        K = scores.shape[0]
        gate = torch.rand((K,), generator=generator,
                          device=scores.device) < self.ratio
        mean = torch.softmax(scores.detach(), -1).mean(dim=(1, 2, 3))
        e = torch.empty_like(mean).exponential_(1.0, generator=generator)
        ratio = (mean + 1e-20) / e
        top = ratio.topk(2, dim=-1).values
        return gate, ratio.argmax(-1), (top[:, 0] - top[:, 1]) / top[:, 0]

    @staticmethod
    def mask_of(gate, pick, n_keys: int):
        """The [K, T] bias of a draw: -1e9 on the picked key of a gated
        stream."""
        hit = F.one_hot(pick, n_keys).float() * NEG_INF
        return torch.where(gate[:, None], hit, 0.0)


class TransformerBlock(nn.Module):
    def __init__(self, dim, heads, context_dim, bank: bool, spec: UNetSpec):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads)
        if bank:
            self.task_attn = TaskAttentionBank(dim, spec)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)


class Transformer2D(nn.Module):
    def __init__(self, c, heads, context_dim, bank: bool, spec: UNetSpec):
        super().__init__()
        self.norm = GroupNorm(spec.norm_groups, c, 1e-6)
        self.proj_in = Linear(c, c)
        self.transformer_blocks_0 = TransformerBlock(c, heads, context_dim,
                                                     bank, spec)
        self.proj_out = Linear(c, c)

    def front(self, x):
        """(tokens after proj_in, the self-attention's output): what no
        conditioning reaches."""
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W,
                                                                  C))
        blk = self.transformer_blocks_0
        return h, blk.attn1(blk.norm1(h))

    def back(self, x, h, a1, ctx, bank_args, tap: Optional[str]):
        """The rest of the layer from `front`'s state; returns (out, the
        tap 'afterSelfAttn_residual' or None)."""
        blk = self.transformer_blocks_0
        if hasattr(blk, "task_attn") and bank_args is not None:
            a1 = a1 + blk.task_attn(a1, **bank_args)
        h = h + a1
        h = h + blk.attn2(blk.norm2(h), ctx)
        h = h + blk.ff(blk.norm3(h))
        B, C, H, W = x.shape
        out = self.proj_out(h).reshape(B, H, W, C).permute(0, 3, 1, 2) + x
        return out, (a1 if tap == "afterSelfAttn_residual" else None)


class UNet(nn.Module):
    def __init__(self, spec: UNetSpec):
        super().__init__()
        self.spec = s = spec
        ch, n = s.block_out_channels, len(s.block_out_channels)
        temb = ch[0] * 4

        def tr(c, heads):
            return Transformer2D(c, heads, s.cross_attention_dim,
                                 s.task_attention, s)

        def rn(cin, cout):
            return ResnetBlock(cin, cout, temb, s.norm_groups, 1e-5)

        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.conv_in = Conv(s.in_channels, ch[0], 3, padding=1)
        cur, res = ch[0], [ch[0]]
        for i in range(n):
            for j in range(s.layers_per_block):
                self.add_module(f"down_blocks_{i}_resnets_{j}", rn(cur, ch[i]))
                cur = ch[i]
                if i < n - 1:
                    self.add_module(f"down_blocks_{i}_attentions_{j}",
                                    tr(cur, s.attention_heads[i]))
                res.append(cur)
            if i < n - 1:
                self.add_module(f"down_blocks_{i}_downsamplers_0", Holder(
                    Conv(cur, cur, 3, stride=2, padding=1)))
                res.append(cur)
        self.mid_block_resnets_0 = rn(cur, cur)
        self.mid_block_attentions_0 = tr(cur, s.attention_heads[-1])
        self.mid_block_resnets_1 = rn(cur, cur)
        rch, rheads = ch[::-1], s.attention_heads[::-1]
        for i in range(n):
            skips, res = res[-(s.layers_per_block + 1):], \
                res[:-(s.layers_per_block + 1)]
            for j in range(s.layers_per_block + 1):
                self.add_module(f"up_blocks_{i}_resnets_{j}",
                                rn(cur + skips.pop(), rch[i]))
                cur = rch[i]
                if i > 0:
                    self.add_module(f"up_blocks_{i}_attentions_{j}",
                                    tr(cur, rheads[i]))
            if i < n - 1:
                self.add_module(f"up_blocks_{i}_upsamplers_0",
                                Holder(UpsampleConv(cur)))
        self.conv_norm_out = GroupNorm(s.norm_groups, cur, 1e-5)
        self.conv_out = Conv(cur, s.out_channels, 3, padding=1)

    def layer_names(self):
        s, n = self.spec, len(self.spec.block_out_channels)
        names = [f"down_blocks_{i}_attentions_{j}" for i in range(n - 1)
                 for j in range(s.layers_per_block)]
        names.append("mid_block_attentions_0")
        names += [f"up_blocks_{i}_attentions_{j}" for i in range(1, n)
                  for j in range(s.layers_per_block + 1)]
        return names

    def banks(self):
        return [getattr(self, n).transformer_blocks_0.task_attn
                for n in self.layer_names()] if self.spec.task_attention \
            else []

    def forward(self, x_variants, pick: Sequence[int], ctx, tap=None,
                bank_args=None):
        """x_variants [V, B, H, W, C_in] (NHWC): the distinct inputs; the
        streams are rows k*B + b of stream k, whose input is variant
        pick[k]. ctx [K*B, L, D]. bank_args: per attention layer, the
        keyword arguments of its bank (or None), given the layer index.
        Returns (out [K*B, H, W, C_out], taps: per layer [K*B, N, C] or
        None)."""
        s = self.spec
        V, B = x_variants.shape[:2]
        x = x_variants.flatten(0, 1).permute(0, 3, 1, 2)
        t = torch.full((V * B,), 999.0, device=x.device)
        temb = self.time_embedding(timestep_embedding(
            t, s.block_out_channels[0]))
        # the prefix, once per distinct input
        h0 = self.conv_in(x)
        r0 = self.down_blocks_0_resnets_0(h0, temb)
        hp, a1 = self.down_blocks_0_attentions_0.front(r0)
        idx = torch.tensor([v * B + b for v in pick for b in range(B)],
                           device=x.device)
        temb, h0, r0, hp, a1 = (z[idx] for z in (temb, h0, r0, hp, a1))
        taps = []
        n = len(s.block_out_channels)

        def layer(name, h, front=None):
            li = len(taps)
            m = getattr(self, name)
            hh, aa = front if front is not None else m.front(h)
            out, tp = m.back(h, hh, aa, ctx,
                             None if bank_args is None else bank_args(li),
                             tap)
            taps.append(tp)
            return out

        res = [h0]
        h = r0
        for i in range(n):
            for j in range(s.layers_per_block):
                if not (i == 0 and j == 0):
                    h = getattr(self, f"down_blocks_{i}_resnets_{j}")(h, temb)
                if i < n - 1:
                    h = layer(f"down_blocks_{i}_attentions_{j}", h,
                              (hp, a1) if i == 0 and j == 0 else None)
                res.append(h)
            if i < n - 1:
                h = getattr(self, f"down_blocks_{i}_downsamplers_0").conv(h)
                res.append(h)
        h = self.mid_block_resnets_0(h, temb)
        h = layer("mid_block_attentions_0", h)
        h = self.mid_block_resnets_1(h, temb)
        for i in range(n):
            skips, res = res[-(s.layers_per_block + 1):], \
                res[:-(s.layers_per_block + 1)]
            for j in range(s.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = getattr(self, f"up_blocks_{i}_resnets_{j}")(h, temb)
                if i > 0:
                    h = layer(f"up_blocks_{i}_attentions_{j}", h)
            if i < n - 1:
                h = getattr(self, f"up_blocks_{i}_upsamplers_0").conv(
                    h, tuple(res[-1].shape[2:]))
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.permute(0, 2, 3, 1), taps


class VAEAttention(nn.Module):
    def __init__(self, c, groups):
        super().__init__()
        self.group_norm = GroupNorm(groups, c, 1e-6)
        self.to_q, self.to_k = Linear(c, c), Linear(c, c)
        self.to_v, self.to_out_0 = Linear(c, c), Linear(c, c)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = self.to_out_0(attention(self.to_q(h), self.to_k(h),
                                    self.to_v(h), 1))
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


class Encoder(nn.Module):
    def __init__(self, s: VAESpec):
        super().__init__()
        ch, g = s.block_out_channels, s.norm_groups
        self.n, self.lpb = len(ch), s.layers_per_block
        self.conv_in = Conv(s.in_channels, ch[0], 3, padding=1)
        cur = ch[0]
        for i in range(self.n):
            for j in range(self.lpb):
                self.add_module(f"down_blocks_{i}_resnets_{j}",
                                ResnetBlock(cur, ch[i], None, g, 1e-6))
                cur = ch[i]
            if i < self.n - 1:
                self.add_module(f"down_blocks_{i}_downsamplers_0_conv",
                                Conv(cur, cur, 3, stride=2))
        self.mid_block_resnets_0 = ResnetBlock(cur, cur, None, g, 1e-6)
        self.mid_block_attentions_0 = VAEAttention(cur, g)
        self.mid_block_resnets_1 = ResnetBlock(cur, cur, None, g, 1e-6)
        self.conv_norm_out = GroupNorm(g, cur, 1e-6)
        self.conv_out = Conv(cur, 2 * s.latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for i in range(self.n):
            for j in range(self.lpb):
                h = getattr(self, f"down_blocks_{i}_resnets_{j}")(h)
            if i < self.n - 1:
                h = getattr(self, f"down_blocks_{i}_downsamplers_0_conv")(
                    F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block_resnets_1(self.mid_block_attentions_0(
            self.mid_block_resnets_0(h)))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, s: VAESpec):
        super().__init__()
        rch, g = s.block_out_channels[::-1], s.norm_groups
        self.n, self.lpb = len(rch), s.layers_per_block
        self.conv_in = Conv(s.latent_channels, rch[0], 3, padding=1)
        self.mid_block_resnets_0 = ResnetBlock(rch[0], rch[0], None, g, 1e-6)
        self.mid_block_attentions_0 = VAEAttention(rch[0], g)
        self.mid_block_resnets_1 = ResnetBlock(rch[0], rch[0], None, g, 1e-6)
        cur = rch[0]
        for i in range(self.n):
            for j in range(self.lpb + 1):
                self.add_module(f"up_blocks_{i}_resnets_{j}",
                                ResnetBlock(cur, rch[i], None, g, 1e-6))
                cur = rch[i]
            if i < self.n - 1:
                self.add_module(f"up_blocks_{i}_upsamplers_0_conv",
                                UpsampleConv(cur))
        self.conv_norm_out = GroupNorm(g, cur, 1e-6)
        self.conv_out = Conv(cur, s.out_channels, 3, padding=1)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid_block_resnets_1(self.mid_block_attentions_0(
            self.mid_block_resnets_0(h)))
        for i in range(self.n):
            for j in range(self.lpb + 1):
                h = getattr(self, f"up_blocks_{i}_resnets_{j}")(h)
            if i < self.n - 1:
                h = getattr(self, f"up_blocks_{i}_upsamplers_0_conv")(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class VAE(nn.Module):
    def __init__(self, spec: VAESpec):
        super().__init__()
        self.spec = spec
        lat = spec.latent_channels
        self.encoder, self.decoder = Encoder(spec), Decoder(spec)
        self.quant_conv = Conv(2 * lat, 2 * lat, 1)
        self.post_quant_conv = Conv(lat, lat, 1)

    def encode(self, x):
        """[-1, 1] NHWC -> the scaled latent mean, NHWC."""
        m = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        lat = self.spec.latent_channels
        return (m[:, :lat] * self.spec.scaling_factor).permute(0, 2, 3, 1)

    def decode(self, z):
        """Scaled latent NHWC -> image NHWC."""
        z = z.permute(0, 3, 1, 2) / self.spec.scaling_factor
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)
