"""Transformer blocks with cross-task attention.

Counterpart of `stablemtl_tpu/models/transformer.py`. Per-task K/V/Q
projector parameters are stacked banks [n_tasks, ...] that keep their Flax
names and layout; task identity is data (an index tensor). In training the
stochastic task-masking regularizer draws from an explicit torch.Generator,
layer after layer in traversal order.

Several main streams can share one forward: their rows are folded into the
batch task-major (rows k*B + b for stream k), `main_idx` gives each
stream's task, and the cross-task K/V tables ([n_tasks, B, N, C], one per
input) broadcast over the streams without being copied.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..parallel.tensor_parallel import (copy_to_model, gather_from_model,
                                        reduce_from_model, row_linear,
                                        scatter_to_model)
from ..utils.env import no_fused_qkv
from ..utils.profiling import span
from .layers import Dense, FeedForward, GroupNorm, LayerNorm, cast

NEG_INF = -1e9
MASK_TYPES = ("attn_prob", "random", "highest", "attn_prob_random_k")

TAP_POINTS = (
    "beforeSelfAttn",
    "afterSelfAttn_main", "afterSelfAttn_residual",
    "afterXAttn_main", "afterXAttn_residual",
    "afterFF_main", "afterFF_residual",
)


class Attention(nn.Module):
    """Multi-head attention, self (fused QKV matmul) or cross.

    STABLEMTL_NO_FUSED_QKV (read at each call, as the JAX package reads it
    at trace time) projects self-attention's q, k and v with three
    products, as cross-attention does, instead of one over the concatenated
    weight: the same math per output column.

    Under tensor parallelism (`tp`, the mesh) the projections hold this
    rank's output features. Where the model size divides the heads, the
    attention runs on the local heads; where it does not, q, k and v are
    all-gathered and every rank runs all heads, then `to_out_0` takes its
    slice of the output channels. Either way `to_out_0`'s partial sums are
    reduced over the model group."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 out_dim: int, context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Dense(query_dim, inner, bias=False)
        self.to_k = Dense(context_dim or query_dim, inner, bias=False)
        self.to_v = Dense(context_dim or query_dim, inner, bias=False)
        self.to_out_0 = Dense(inner, out_dim)
        self.tp = None

    def forward(self, x, context=None):
        tp = self.tp
        if tp is not None:
            x = copy_to_model(x, tp)
            if context is not None:
                context = copy_to_model(cast(context, x.dtype), tp)
        if context is None and no_fused_qkv():
            q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        elif context is None:
            w = cast(torch.cat([self.to_q.weight, self.to_k.weight,
                                self.to_v.weight]), x.dtype)
            q, k, v = F.linear(x, w).chunk(3, dim=-1)
        else:
            context = cast(context, x.dtype)
            q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)
        heads = self.heads
        local_heads = tp is not None and heads % tp.model == 0
        if local_heads:
            heads //= tp.model
        elif tp is not None:
            q, k, v = (gather_from_model(t, tp) for t in (q, k, v))
        B, N, _ = q.shape
        L = k.shape[1]
        out = dot_product_attention(
            q.reshape(B, N, heads, self.dim_head),
            k.reshape(B, L, heads, self.dim_head),
            v.reshape(B, L, heads, self.dim_head))
        out = out.reshape(B, N, heads * self.dim_head)
        if tp is None:
            return self.to_out_0(out)
        if not local_heads:
            out = scatter_to_model(out, tp)
        return row_linear(self.to_out_0, out, tp)


def _ln_bank(x, scale, bias, eps=1e-5):
    """LayerNorm over the last axis with externally gathered scale/bias."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _bank_linear(bank, x, w, b, name, local: bool):
    """x [T, R, in] @ w [T, in, out] + b [T, out] for the bank's leaf
    `name`, following its tensor-parallel split (`bank.tp_axes`; none
    without tensor parallelism): a column
    bank (axis 2) takes whole features and gives local ones, a row bank
    (axis 1) takes local features (slicing whole ones) and reduces its
    partial sums over the model group before its bias; a whole bank takes
    whole features (gathering local ones). Returns (y, local)."""
    tp = bank.tp
    axis = None if tp is None else bank.tp_axes.get(name)
    if axis == 2:
        if local:
            x = gather_from_model(x, tp)
        return torch.bmm(copy_to_model(x, tp), w) + b[:, None, :], True
    if axis == 1:
        if not local:
            x = scatter_to_model(x, tp)
        return reduce_from_model(torch.bmm(x, w), tp) + b[:, None, :], False
    if local:
        x = gather_from_model(x, tp)
    return torch.bmm(x, w) + b[:, None, :], False


def _kv_project(bank, feats, idx, nm, dtype, fast_gelu: bool = False):
    """K or V task projection LN_t -> MLP(C -> C/2 -> C) of bank `bank`, for
    tasks `idx` ([T] long or None = all), on feats [T, B, N, C]."""
    def g(name):
        p = getattr(bank, name)
        return p if idx is None else p[idx]

    T, B, N, C = feats.shape
    x = _ln_bank(feats, g(f"task_norm_{nm}_scale")[:, None, None, :],
                 g(f"task_norm_{nm}_bias")[:, None, None, :])
    x = x.reshape(T, B * N, C)
    local = False
    for li, fc in enumerate(("fc1", "fc2")):
        name = f"task_to_{nm}_{fc}_kernel"
        x, local = _bank_linear(bank, x, cast(g(name), dtype),
                                cast(g(f"task_to_{nm}_{fc}_bias"), dtype),
                                name, local)
        if li == 0:
            x = F.gelu(x, approximate="tanh" if fast_gelu else "none")
    if local:
        x = gather_from_model(x, bank.tp)
    return x.reshape(T, B, N, C)


class TaskAttentionBank(nn.Module):
    """Cross-task attention for one UNet attention layer.

    Owns stacked per-task banks over all n_tasks (Flax names and layouts:
    kernels [T, in, out], norms [T, C]). Queries come from the main stream
    through its task's Q projector; keys/values are one token per auxiliary
    task per pixel, attended with n_attns heads over the task axis.
    """

    def __init__(self, dim: int, n_tasks: int, n_attns: int = 4,
                 q_hidden: int = 640, q_hidden_layers: int = 2,
                 attn_mask_ratio: float = 0.0,
                 attn_mask_type: str = "attn_prob", dtype=torch.float32,
                 fast_math: bool = False):
        super().__init__()
        C, T, Ch = dim, n_tasks, dim // 2
        self.dim, self.n_attns = dim, n_attns
        self.attn_mask_ratio = attn_mask_ratio
        self.attn_mask_type = attn_mask_type
        self.dtype, self.fast_math = dtype, fast_math
        # the data-parallel mesh while the pipeline's `data_parallel` holds
        # it: the masking statistic is then the global batch's
        self.data_group = None
        # tensor parallelism (parallel/tensor_parallel.py): the mesh and
        # each split leaf's axis
        self.tp = None
        self.tp_axes = {}

        def param(name, *shape):
            self.register_parameter(name, nn.Parameter(torch.empty(*shape)))

        for nm in ("k", "v"):
            param(f"task_norm_{nm}_scale", T, C)
            param(f"task_norm_{nm}_bias", T, C)
            param(f"task_to_{nm}_fc1_kernel", T, C, Ch)
            param(f"task_to_{nm}_fc1_bias", T, Ch)
            param(f"task_to_{nm}_fc2_kernel", T, Ch, C)
            param(f"task_to_{nm}_fc2_bias", T, C)
        param("task_norm_q_scale", T, C)
        param("task_norm_q_bias", T, C)
        self.q_dims = [C] + [q_hidden] * (q_hidden_layers + 1) + [C]
        for li in range(len(self.q_dims) - 1):
            param(f"task_to_q_net_{2 * li}_kernel", T, self.q_dims[li],
                  self.q_dims[li + 1])
            param(f"task_to_q_net_{2 * li}_bias", T, self.q_dims[li + 1])
        param("to_out_task_kernel", C, C)
        param("to_out_task_bias", C)

    def forward(self, hidden, task_feats, main_idx, aux_idx=None,
                train: bool = False, task_kv=None, task_key_bias=None,
                generator: Optional[torch.Generator] = None):
        """
        hidden: [K*B, N, C] main-stream features, K streams folded
            task-major.
        task_feats: [T_aux, B, N, C] child features of the auxiliary tasks
            `aux_idx` ([T_aux] long); unused when task_kv is given.
        main_idx: [K] long (or a scalar for K=1), each stream's task.
        task_kv: (k_all, v_all) [n_tasks, B, N, C] over ALL tasks; the keys
            of each stream are then masked by task_key_bias [K, n_tasks]
            (-1e9 on excluded tasks), which equals gathering the aux subset.
        train, generator: the task-masking regularizer (`_mask_bias`) runs
            when train and attn_mask_ratio > 0, drawing from `generator`.
        Returns [K*B, N, C], to be added to `hidden`. The call is the
        span `stablemtl.bank` (`utils.profiling`, with device events).
        """
        with span("stablemtl.bank", device=hidden.device):
            return self._attend(hidden, task_feats, main_idx, aux_idx,
                                train, task_kv, task_key_bias, generator)

    def _attend(self, hidden, task_feats, main_idx, aux_idx, train, task_kv,
                task_key_bias, generator):
        dtype = self.dtype
        if task_kv is not None:
            k_all, v_all = (t.to(dtype) for t in task_kv)
        else:
            k_all = _kv_project(self, task_feats, aux_idx, "k", dtype,
                                self.fast_math)
            v_all = _kv_project(self, task_feats, aux_idx, "v", dtype,
                                self.fast_math)
        T, B = k_all.shape[:2]
        R, N, C = hidden.shape
        K = R // B
        main_idx = torch.as_tensor(main_idx, device=hidden.device).reshape(-1)
        if main_idx.numel() != K:
            raise ValueError(f"{R} rows over a batch of {B} make {K} streams,"
                             f" but main_idx has {main_idx.numel()}")

        # ---- Q projector: LN_m -> MLPv2(C -> 640 x3 -> C), per stream ----
        q = _ln_bank(hidden, self.task_norm_q_scale[main_idx][:, None, :]
                     .repeat_interleave(B, dim=0),
                     self.task_norm_q_bias[main_idx][:, None, :]
                     .repeat_interleave(B, dim=0))
        q = q.reshape(K, B * N, C)
        n_lin = len(self.q_dims) - 1
        local = False
        for li in range(n_lin):
            name = f"task_to_q_net_{2 * li}_kernel"
            w = cast(getattr(self, name)[main_idx], dtype)
            b = getattr(self, f"task_to_q_net_{2 * li}_bias")[main_idx]
            q, local = _bank_linear(self, q, w, cast(b, dtype), name, local)
            if li < n_lin - 1:
                q = F.gelu(q, approximate="tanh" if self.fast_math
                           else "none")
        if local:
            q = gather_from_model(q, self.tp)

        # ---- attention over the task axis, per pixel ----------------------
        h, d = self.n_attns, C // self.n_attns
        qh = q.reshape(K, B, N, h, d).float()
        kh = k_all.reshape(T, B, N, h, d).float()
        vh = v_all.reshape(T, B, N, h, d).float()
        scores = torch.einsum("kbnhd,tbnhd->kbnht", qh, kh) * d ** -0.5
        key_valid = None
        if task_key_bias is not None:
            bias = task_key_bias.float().reshape(-1, T)
            scores = scores + bias[:, None, None, None, :]
            # in the task_kv layout the key axis spans ALL tasks: tell the
            # mask sampler which keys are real
            key_valid = bias > NEG_INF / 2
        mask = self._mask_bias(scores, train, generator, key_valid)
        if mask is not None:
            scores = scores + mask[:, None, None, None, :]
        probs = torch.softmax(scores, dim=-1).to(dtype).float()
        out = torch.einsum("kbnht,tbnhd->kbnhd", probs, vh).to(dtype)
        out = out.reshape(R, N, C)
        return (out @ cast(self.to_out_task_kernel, dtype)
                + cast(self.to_out_task_bias, dtype))

    def _mask_bias(self, scores, train: bool,
                   generator: Optional[torch.Generator] = None,
                   key_valid=None):
        """Stochastic task-masking regularizer (the JAX bank's `_mask_bias`).

        scores: [K, B, N, h, T] f32, the key bias already added. For each
        stream, with probability attn_mask_ratio, pick key(s) from the
        stream's mean attention distribution over (B, N, h) and bias them
        to -1e9: 'attn_prob' samples one key from it, 'random' one real key
        uniformly, 'highest' takes its argmax, 'attn_prob_random_k' samples
        1..n_real-1 keys without replacement (Gumbel top-k). key_valid
        ([K, T] bool or None) marks the real keys: in the task_kv layout the
        axis spans all tasks and excluded keys must never be picked or
        counted. Returns [K, T], or None when masking is off.

        The draws come from `generator` (the gate, then the pick); they are
        not JAX's random bits, so only 'highest' at ratio 1 reproduces the
        JAX package's masks exactly.
        """
        K, T = scores.shape[0], scores.shape[-1]
        if not train or self.attn_mask_ratio <= 0.0 or T <= 1:
            return None
        kind = self.attn_mask_type
        if kind not in MASK_TYPES:
            raise ValueError(f"Invalid attn_mask_type: {kind}")
        if generator is None:
            raise ValueError("task masking in training needs a generator")

        def rand(*shape):
            return torch.rand(shape, generator=generator,
                              device=scores.device)

        do_mask = rand(K) < self.attn_mask_ratio
        mean_probs = torch.softmax(scores.detach(), dim=-1).mean(dim=(1, 2, 3))
        if self.data_group is not None:
            # a mean over the global batch: every rank's local B is equal
            self.data_group.mean_(mean_probs)
        valid = (torch.ones_like(mean_probs, dtype=torch.bool)
                 if key_valid is None else key_valid.expand(K, T))
        if kind == "attn_prob_random_k":
            n_real = valid.sum(dim=-1)
            n_mask = 1 + (rand(K) * (n_real.clamp(min=2) - 1)).long()
            gumbel = -torch.log(-torch.log(rand(K, T) + 1e-20) + 1e-20)
            g = torch.where(valid, torch.log(mean_probs + 1e-20) + gumbel,
                            -torch.inf)
            rank = torch.argsort(torch.argsort(-g, dim=-1), dim=-1)
            mask = (rank < n_mask[:, None]).float()
        else:
            if kind == "highest":
                idx = mean_probs.argmax(dim=-1)
            else:
                weights = (mean_probs + 1e-20 if kind == "attn_prob"
                           else valid.float())
                idx = torch.multinomial(weights, 1, generator=generator)[:, 0]
            mask = F.one_hot(idx, T).float()
        return torch.where(do_mask[:, None], mask * NEG_INF, 0.0)


class BasicTransformerBlock(nn.Module):
    """self-attn (+ cross-task) -> text cross-attn -> GEGLU FF, pre-LN."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: int, n_tasks: int = 0,
                 use_task_attention: bool = False, n_attns: int = 4,
                 attn_mask_ratio: float = 0.0,
                 attn_mask_type: str = "attn_prob", dtype=torch.float32,
                 fast_math: bool = False):
        super().__init__()
        self.dtype = dtype
        # norms emit the compute dtype under fast_math, else f32
        self.ndt = dtype if fast_math else torch.float32
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head, dim)
        if use_task_attention:
            self.task_attn = TaskAttentionBank(
                dim, n_tasks, n_attns=n_attns,
                attn_mask_ratio=attn_mask_ratio,
                attn_mask_type=attn_mask_type, dtype=dtype,
                fast_math=fast_math)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dim_head, dim,
                               context_dim=context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim, fast_gelu=fast_math)

    def forward(self, x, context, task_feats=None, main_idx=None,
                aux_idx=None, tap: Optional[str] = None, train: bool = False,
                task_kv=None, task_key_bias=None, front_only: bool = False,
                front_state=None, generator=None):
        """front_only returns the self-attention output (everything before
        any conditioning); front_state is that output, batched to x's batch,
        and skips norm1/attn1. train/generator reach the task bank's
        masking. Returns (x, tap_feat)."""
        tap_feat = x if tap == "beforeSelfAttn" else None
        if front_state is None:
            attn_out = self.attn1(cast(self.norm1(x, self.ndt), self.dtype))
            if front_only:
                return attn_out
        else:
            attn_out = front_state
        if hasattr(self, "task_attn") and (task_feats is not None
                                           or task_kv is not None):
            attn_out = attn_out + self.task_attn(
                attn_out, task_feats, main_idx, aux_idx, train=train,
                task_kv=task_kv, task_key_bias=task_key_bias,
                generator=generator)
        x = x + attn_out
        if tap == "afterSelfAttn_residual":
            tap_feat = attn_out
        elif tap == "afterSelfAttn_main":
            tap_feat = x

        xattn_out = self.attn2(cast(self.norm2(x, self.ndt), self.dtype),
                               context)
        x = x + xattn_out
        if tap == "afterXAttn_residual":
            tap_feat = xattn_out
        elif tap == "afterXAttn_main":
            tap_feat = x

        ff_out = self.ff(cast(self.norm3(x, self.ndt), self.dtype))
        x = x + ff_out
        if tap == "afterFF_residual":
            tap_feat = ff_out
        elif tap == "afterFF_main":
            tap_feat = x
        return x, tap_feat


class Transformer2D(nn.Module):
    """GroupNorm -> linear proj_in -> `n_blocks` transformer blocks
    (`transformer_blocks_0` ...; one for SD2, up to 10 for SDXL) ->
    proj_out + residual, on NCHW maps. Each block has its own task bank
    (where `use_task_attention`, one flag for all blocks or one a block,
    says so) and gives its own tap.

    Under tensor parallelism (`tp`, the mesh) `proj_in` gives this rank's
    output features, which are all-gathered: the blocks' LayerNorms, the
    residual stream and the task banks' input stay whole and replicated
    on every model rank. `proj_out` takes this rank's slice of the stream
    and its partial sums are reduced over the model group."""

    def __init__(self, in_channels: int, heads: int, dim_head: int,
                 context_dim: int, n_tasks: int = 0,
                 use_task_attention=False, n_attns: int = 4,
                 attn_mask_ratio: float = 0.0,
                 attn_mask_type: str = "attn_prob", norm_groups: int = 32,
                 dtype=torch.float32, fast_math: bool = False,
                 n_blocks: int = 1):
        super().__init__()
        inner = heads * dim_head
        self.dtype = dtype
        self.ndt = dtype if fast_math else torch.float32
        self.n_blocks = n_blocks
        banks = (list(use_task_attention)
                 if isinstance(use_task_attention, (list, tuple))
                 else [use_task_attention] * n_blocks)
        if len(banks) != n_blocks:
            raise ValueError(f"{len(banks)} task-attention flags for "
                             f"{n_blocks} blocks")
        self.norm = GroupNorm(norm_groups, in_channels, eps=1e-6)
        self.proj_in = Dense(in_channels, inner)
        for k in range(n_blocks):
            self.add_module(f"transformer_blocks_{k}", BasicTransformerBlock(
                inner, heads, dim_head, context_dim, n_tasks=n_tasks,
                use_task_attention=banks[k], n_attns=n_attns,
                attn_mask_ratio=attn_mask_ratio,
                attn_mask_type=attn_mask_type, dtype=dtype,
                fast_math=fast_math))
        self.proj_out = Dense(inner, in_channels)
        self.tp = None

    def forward(self, x, context, task_feats=None, main_idx=None,
                aux_idx=None, tap: Optional[str] = None, train: bool = False,
                task_kv=None, task_key_bias=None, front_only: bool = False,
                front_state=None, generator=None):
        """front_only: run GroupNorm + proj_in + the first block's
        norm1/attn1 and return (h_proj, attn1), the state shared across
        task streams. front_state: that pair batched to x's batch (x is
        still the layer input: the residual). With one block, task_feats
        and task_kv are its own and the tap comes back alone; with several
        they hold one entry a block (or are None) and the taps come back
        as a list, in block order. Returns (x, tap_feat)."""
        B, C, H, W = x.shape
        block = self.transformer_blocks_0
        if front_state is None:
            h = self.norm(x, self.ndt).permute(0, 2, 3, 1)
            h = cast(h.reshape(B, H * W, C), self.dtype)
            if self.tp is None:
                h = self.proj_in(h)
            else:
                h = gather_from_model(self.proj_in(copy_to_model(
                    h, self.tp)), self.tp)
            if front_only:
                return h, block(h, context, front_only=True)
            attn1 = None
        else:
            h, attn1 = front_state
        n = self.n_blocks

        def per_block(x):
            return [x] if n == 1 else [None] * n if x is None else x

        taps = []
        for k, (feats, kv) in enumerate(zip(per_block(task_feats),
                                            per_block(task_kv))):
            h, tap_feat = getattr(self, f"transformer_blocks_{k}")(
                h, context, feats, main_idx, aux_idx, tap=tap, train=train,
                task_kv=kv, task_key_bias=task_key_bias,
                front_state=attn1 if k == 0 else None, generator=generator)
            taps.append(tap_feat)
        h = (self.proj_out(h) if self.tp is None else row_linear(
            self.proj_out, scatter_to_model(h, self.tp), self.tp))
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
        return h + x, taps[0] if n == 1 else taps
