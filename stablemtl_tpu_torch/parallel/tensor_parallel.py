"""Tensor parallelism over the mesh's model axis. Counterpart of
`stablemtl_tpu/parallel/tensor_parallel.py`.

The JAX module is a naming policy: it shards the transformer projections'
parameters over the `model` axis and GSPMD inserts every collective. The
port runs one process a rank, so the policy here (`tp_axis`, the same
names and divisibility guards) is followed by code that computes on the
local shards and communicates by hand:

- `shard_unet` slices a built UNet's parameters to this rank's shards, in
  place, and hands the model group to the modules that hold them
  (`Attention`, `FeedForward`, `Transformer2D`, `TaskAttentionBank`);
- four differentiable collectives over the model group, Megatron's:
  `copy_to_model` (identity forward, all-reduce of the gradient) before
  each column-parallel product, `reduce_from_model` (all-reduce forward,
  identity backward) after each row-parallel one, `gather_from_model`
  (all-gather of the last axis forward, this rank's slice of the
  gradient backward) and `scatter_to_model` (the slice forward, the
  all-gather of the gradient backward). `torch.distributed.nn`'s
  all_reduce is not used: its backward all-reduces again, which makes
  every gradient upstream of a row-parallel product `model` times too
  large.

Policy (the JAX module's, in the port's layouts): column-parallel modules
(`to_q`, `to_k`, `to_v`, GEGLU's `proj`, `proj_in`) shard their output
features, axis 0 of a Dense weight [out, in] and the only axis of their
bias; row-parallel modules (`to_out_0`, `net_2`, `proj_out`) shard axis 1
of the weight, and their bias stays whole, added once after the
reduction. The stacked task banks keep the Flax layout [T, in, out]:
column banks (`task_to_{k,v}_fc1`, `task_to_q_net_{0,4}`) shard axis 2
and their biases axis 1, row banks (`task_to_{k,v}_fc2`,
`task_to_q_net_{2,6}`) axis 1. A leaf whose axis the model size does not
divide stays whole, and so does everything else: convolutions, norms,
embeddings, `to_out_task`, the child UNet and the VAE.

Two layouts differ from JAX's contiguous split, where the numbers would
not allow it (GSPMD reshards as needed; hand-written code cannot):
- GEGLU's projection [2F, C] holds the value rows, then the gate rows.
  Rank r holds value rows [rF/M, (r+1)F/M) and the same gate rows, so
  the local [2F/M, C] is a well-formed GEGLU (the fused kernel K6 takes
  it); the checkpoint puts the halves back in place (`TPLayout.whole`).
- Attention runs on local heads where the heads divide (K3-K5 see
  heads/M). Where they do not (SD2's stage 0: 5 heads over 2 ranks), the
  projections keep JAX's feature split (to_q [160, 320] a rank), q, k
  and v are all-gathered, every rank runs all the heads, and `to_out_0`
  takes its slice of the attention's output channels.

`Transformer2D` all-gathers `proj_in`'s output, so the LayerNorms, the
residual stream and the banks' inputs stay whole and replicated on every
model rank; `proj_out` takes its slice of the stream. The task-axis
attention, `to_out_task` and the masking statistic run on whole tensors
(the statistic's mean over the data group only).

JAX's `opt_leaf_param_names` (an optimizer-state path to its parameter's)
has no counterpart: the port's `Optimizer` keeps per-leaf lists aligned
with the parameters, so a moment's split is its parameter's by index.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

# column-parallel (shard output features) / row-parallel (shard input
# features) module names, matched against the parameter's module name
_COL_MODULES = ("to_q", "to_k", "to_v", "proj", "net_0", "proj_in")
_ROW_MODULES = ("to_out_0", "net_2", "proj_out")

# cross-task bank leaf names [T, din, dout]: column / row parallel
_COL_BANKS = ("task_to_k_fc1_kernel", "task_to_v_fc1_kernel",
              "task_to_q_net_0_kernel", "task_to_q_net_4_kernel")
_ROW_BANKS = ("task_to_k_fc2_kernel", "task_to_v_fc2_kernel",
              "task_to_q_net_2_kernel", "task_to_q_net_6_kernel")
_COL_BANK_BIASES = tuple(n.replace("_kernel", "_bias") for n in _COL_BANKS)


def tp_axis(name: str, shape: Sequence[int], model: int) -> Optional[int]:
    """The axis of port parameter `name` (of whole shape `shape`) that the
    model axis of size `model` splits, or None (whole on every rank): the
    JAX package's `tp_spec`, on the port's names and layouts."""
    if model <= 1:
        return None
    parts = name.split(".")
    leaf = parts[-1]
    mod = parts[-2] if len(parts) >= 2 else ""
    shape = tuple(shape)

    def ok(axis):
        return shape[axis] % model == 0

    if leaf == "weight" and len(shape) == 2:
        if mod in _COL_MODULES and ok(0):
            return 0
        if mod in _ROW_MODULES and ok(1):
            return 1
    if leaf == "bias" and len(shape) == 1 and mod in _COL_MODULES and ok(0):
        return 0
    if leaf in _COL_BANKS and len(shape) == 3 and ok(2):
        return 2
    if leaf in _ROW_BANKS and len(shape) == 3 and ok(1):
        return 1
    if leaf in _COL_BANK_BIASES and len(shape) == 2 and ok(1):
        return 1
    return None


def _groups(name: str) -> int:
    """2 for GEGLU's projection (value and gate halves, each split), else
    1."""
    return 2 if name.endswith(("net_0.proj.weight", "net_0.proj.bias")) \
        else 1


class TPLayout:
    """Which parameters the model axis splits and how: `specs` {name:
    (axis, groups)}, `groups` contiguous blocks along `axis`, each split
    over the `model` ranks (2 for GEGLU's value and gate halves).
    `local` slices a whole tensor to this rank's shard; `whole` gathers
    the shards back (a collective over the model group)."""

    def __init__(self, mesh, specs: Dict[str, Tuple[int, int]],
                 shapes: Dict[str, tuple]):
        self.mesh = mesh
        self.specs = dict(specs)
        self.shapes = dict(shapes)  # whole shapes

    def sharded(self, name: str) -> bool:
        return name in self.specs

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the whole tensor `t` (`t` itself for a
        whole leaf)."""
        spec = self.specs.get(name)
        if spec is None:
            return t
        axis, groups = spec
        m = self.mesh.model
        return t.unflatten(axis, (groups, m, -1)).select(
            axis + 1, self.mesh.model_rank).flatten(axis, axis + 1)

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor from this rank's shard `t`: a collective every
        rank of the model group joins (`t` itself for a whole leaf)."""
        spec = self.specs.get(name)
        if spec is None:
            return t
        axis, groups = spec
        parts = self.mesh.model_all_gather(t)  # [M, *local]
        # [M, ..., groups, n, ...] -> [..., groups, M, n, ...]
        parts = parts.unflatten(axis + 1, (groups, -1))
        return parts.movedim(0, axis + 1).flatten(axis, axis + 2)


def tp_specs(named_shapes, model: int) -> Dict[str, Tuple[int, int]]:
    """{name: (axis, groups)} of the parameters `tp_axis` splits, from
    (name, whole shape) pairs."""
    specs = {}
    for name, shape in named_shapes:
        axis = tp_axis(name, shape, model)
        if axis is None:
            continue
        groups = _groups(name)
        if shape[axis] % (groups * model):
            raise ValueError(f"{name} {tuple(shape)}: GEGLU's {shape[axis]} "
                             f"rows do not split into value and gate halves "
                             f"over {model} ranks")
        specs[name] = (axis, groups)
    return specs


def shard_unet(unet: torch.nn.Module, mesh) -> TPLayout:
    """Slice `unet`'s parameters to this rank's shards over `mesh`'s model
    axis, in place (each parameter object keeps its identity), and give
    the modules that hold shards the mesh (`module.tp`). Returns the
    layout, also kept as `unet.tp_layout`. With mesh.model == 1 nothing
    changes (an empty layout)."""
    from ..models.layers import FeedForward
    from ..models.transformer import (Attention, TaskAttentionBank,
                                      Transformer2D)

    if getattr(unet, "tp_layout", None) is not None:
        raise ValueError("the UNet is sharded already")
    shapes = {n: tuple(p.shape) for n, p in unet.named_parameters()}
    specs = tp_specs(shapes.items(), mesh.model)
    layout = TPLayout(mesh, specs, shapes)
    if not specs:
        unet.tp_layout = layout
        return layout
    with torch.no_grad():
        for name, p in unet.named_parameters():
            if name in specs:
                p.data = layout.local(name, p.data).clone()

    def split(prefix, *leaves) -> bool:
        """Whether the leaves are all split or all whole (raises
        otherwise: a column product without its row partner)."""
        got = {f"{prefix}.{leaf}" in specs for leaf in leaves}
        if len(got) != 1:
            raise ValueError(f"{prefix}: {leaves} are split only in part "
                             f"over {mesh.model} ranks")
        return got.pop()

    kinds = (Attention, FeedForward, Transformer2D, TaskAttentionBank)
    for prefix, module in unet.named_modules():
        if not isinstance(module, kinds):
            continue
        if isinstance(module, Attention):
            on = split(prefix, "to_q.weight", "to_k.weight", "to_v.weight",
                       "to_out_0.weight")
        elif isinstance(module, FeedForward):
            on = split(prefix, "net_0.proj.weight", "net_0.proj.bias",
                       "net_2.weight")
        elif isinstance(module, Transformer2D):
            on = split(prefix, "proj_in.weight", "proj_in.bias",
                       "proj_out.weight")
        else:
            for nm in ("k", "v"):
                split(prefix, f"task_to_{nm}_fc1_kernel",
                      f"task_to_{nm}_fc1_bias", f"task_to_{nm}_fc2_kernel")
            module.tp_axes = {
                n: specs[f"{prefix}.{n}"][0]
                for n, _ in module.named_parameters()
                if f"{prefix}.{n}" in specs}
            on = bool(module.tp_axes)
        if on:
            module.tp = mesh
    unet.tp_layout = layout
    return layout


# ---------------------------------------------------------------------------
# differentiable collectives over the model group
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.model_all_reduce(grad), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.model_all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _gather_last(x, mesh):
    parts = mesh.model_all_gather(x)  # [M, ..., n]
    return torch.cat(list(parts.unbind(0)), dim=-1)


def _slice_last(x, mesh):
    n = x.shape[-1] // mesh.model
    return x.narrow(-1, mesh.model_rank * n, n).contiguous()


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather_last(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _slice_last(grad, ctx.mesh), None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _slice_last(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _gather_last(grad, ctx.mesh), None


def copy_to_model(x, mesh):
    """Before a column-parallel product: x forward; the gradient summed
    over the model group backward (each rank's product gives the part of
    x's gradient that its output features carry)."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x, mesh):
    """After a row-parallel product: the partial sums added over the model
    group forward; the (whole, replicated) gradient passed on backward."""
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x, mesh):
    """The model ranks' x side by side along the last axis, in rank order;
    backward, this rank's slice of the (replicated) gradient."""
    return _GatherFromModel.apply(x, mesh)


def scatter_to_model(x, mesh):
    """This rank's slice of the last axis of the replicated x; backward,
    the slices' gradients all-gathered."""
    return _ScatterToModel.apply(x, mesh)


def row_linear(dense, x, mesh):
    """A row-parallel Dense on local input features x: the partial product
    reduced over the model group, then the (whole) bias added once."""
    y = reduce_from_model(torch.nn.functional.linear(
        x, dense.weight.to(x.dtype)), mesh)
    return y if dense.bias is None else y + dense.bias.to(y.dtype)
