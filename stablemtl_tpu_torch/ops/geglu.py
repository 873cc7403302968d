"""Fused GEGLU projection: the hand-written Hopper kernel K6, its plain
version, and the gate that picks between them.

Counterpart of `stablemtl_tpu/ops/geglu.py`. The feed-forward's GEGLU
computes ``h, g = split(x W^T + b); y = h * gelu(g)`` (exact erf gelu, or
the tanh form under fast math). `geglu_fused` runs that as one CUDA kernel
(`csrc/geglu.cu`, replacing the Pallas `_geglu_kernel`): both halves of the
projection accumulate in f32, the epilogue stays in f32, and only the
gated [R, F] product is written. The kernel is the custom op
`stablemtl::geglu` (`cuda_build.define_op`): a trace records it as one
node, and a loaded program launches it.

The fused path is an inference path, as in the JAX package: its
`custom_vjp` runs the kernel only as the primal and differentiates the
plain formulation. Here `geglu_proj` takes the kernel only when no
gradient is needed for the call, so in training the frozen child (under
no_grad) runs K6 and the trainable main UNet runs the plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.env import env_flag
from . import cuda_build

# the kernel's C chunk and feature tile (csrc/geglu.cu): C and F must be
# multiples of them; any row count is taken
BLOCK_C = 32
BLOCK_F = 64


def geglu_reference(x, weight, bias, fast_gelu: bool):
    """Plain GEGLU in x's dtype: x [..., C], weight [2F, C] (value rows
    first, then gate rows), bias [2F] -> [..., F]. The JAX package's
    `_plain_geglu`."""
    h, g = F.linear(x, weight, bias).chunk(2, dim=-1)
    return h * F.gelu(g, approximate="tanh" if fast_gelu else "none")


def supported(x, weight) -> bool:
    """The kernel's shape gate: C % 32 == 0 and F % 64 == 0 with weight
    [2F, C], at least one row. Wider than the Pallas kernel's (rows % 8,
    C % 8, F % 128 and a VMEM fit): every preset's feed-forward passes it,
    from the tiny preset's (C, F) = (32, 128) to SD2's (1280, 5120)."""
    c = x.shape[-1]
    two_f = weight.shape[0]
    return (x.numel() > 0 and tuple(weight.shape) == (two_f, c)
            and two_f % 2 == 0 and c % BLOCK_C == 0
            and (two_f // 2) % BLOCK_F == 0)


def _geglu_cuda(x, weight, bias, fast_gelu):
    if x.dtype not in cuda_build.DTYPE_CODE or \
            weight.dtype != x.dtype or bias.dtype != x.dtype:
        raise ValueError(f"geglu_fused takes float32 or bfloat16 tensors of "
                         f"one dtype; got {x.dtype}, {weight.dtype}, "
                         f"{bias.dtype}")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("geglu_fused: tensors on different devices")
    if not (weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError("geglu_fused takes a contiguous weight and bias")
    c, f = x.shape[-1], weight.shape[0] // 2
    x2 = x.reshape(-1, c).contiguous()
    if x2.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError("geglu_fused: x and weight must start on 16 bytes "
                         "(the kernel copies 16-byte vectors)")
    out = torch.empty((x2.shape[0], f), dtype=x.dtype, device=x.device)
    cuda_build.launch("geglu", (x2, weight, bias, out), x2.shape[0], c, f,
                      cuda_build.DTYPE_CODE[x.dtype], int(fast_gelu))
    cuda_build.count_launch(geglu_fused)
    return out.reshape(*x.shape[:-1], f)


def _geglu_fake(x, weight, bias, fast_gelu):
    return x.new_empty((*x.shape[:-1], weight.shape[0] // 2))


OP = cuda_build.define_op(
    "geglu", "(Tensor x, Tensor weight, Tensor bias, bool fast_gelu) -> "
    "Tensor", geglu_reference, _geglu_cuda, _geglu_fake)


def geglu_fused(x, weight, bias, fast_gelu: bool):
    """K6 (op `stablemtl::geglu`): fused GEGLU of x [..., C], weight [2F, C],
    bias [2F] -> [..., F], all of one dtype (float32 or bfloat16). A CPU
    tensor runs the plain version. A shape the kernel has no instance for
    raises on either."""
    if not supported(x, weight) or tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(
            f"geglu_fused: unsupported shapes x {tuple(x.shape)}, weight "
            f"{tuple(weight.shape)}, bias {tuple(bias.shape)} (need weight "
            f"[2F, C], bias [2F], C % {BLOCK_C} == 0, F % {BLOCK_F} == 0)")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"geglu_fused takes CUDA or CPU tensors, got "
                         f"{x.device}")
    return OP(x, weight, bias, fast_gelu)


geglu_fused.launches = 0
KERNELS = (geglu_fused,)


def geglu_proj(x, weight, bias, fast_gelu: bool = False,
               use_fused: bool | None = None):
    """GEGLU projection ``split(x W^T + b) -> h * gelu(gate)``: x [..., C],
    weight [2F, C], bias [2F], all in the compute dtype; returns [..., F].

    use_fused None (auto) takes K6 when STABLEMTL_FUSED_GEGLU is on, x lies
    on CUDA and no gradient is needed for this call; a shape outside
    `supported` then raises in `geglu_fused` rather than run the plain
    version unannounced. True forces the kernel and raises for an
    unsupported shape or a tensor off CUDA (the CPU has no kernel), so an
    A/B never compares the plain version with itself; False forbids it.
    Whenever a gradient is needed the plain version runs, as the JAX
    package differentiates its plain formulation."""
    if use_fused and not supported(x, weight):
        raise ValueError(
            f"geglu_proj(use_fused=True): unsupported shape C={x.shape[-1]}"
            f" 2F={weight.shape[0]} (need C % {BLOCK_C} == 0, F % "
            f"{BLOCK_F} == 0)")
    if use_fused and not x.is_cuda:
        raise ValueError(f"geglu_proj(use_fused=True): the kernel runs on "
                         f"CUDA tensors only, got {x.device}")
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, weight, bias))
    if use_fused is None:
        use_fused = env_flag("STABLEMTL_FUSED_GEGLU") and x.is_cuda
    if not use_fused or needs_grad:
        return geglu_reference(x, weight, bias, fast_gelu)
    return geglu_fused(x, weight, bias, fast_gelu)
