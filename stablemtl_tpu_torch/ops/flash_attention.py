"""Flash attention: hand-written Hopper kernels as custom ops, their plain
versions, and the autograd Functions around them.

Each kernel replaces a TPU kernel of `stablemtl_tpu/ops/flash_attention.py`:

| wrapper                  | op                       | TPU kernel          |
| ------------------------ | ------------------------ | ------------------- |
| `flash_fwd_resident`     | `flash_fwd_a` (kernel A) | `_fa_kernel_nolse`  |
| `flash_fwd_resident_lse` | `flash_fwd_lse` (K3)     | `_fa_kernel` + lse  |
| `flash_bwd_dq`           | `flash_bwd_dq` (K4)      | `_fa_dq_kernel`     |
| `flash_bwd_dkv`          | `flash_bwd_dkv` (K5)     | `_fa_dkv_kernel`    |
| `flash_fwd_stream`       | `flash_fwd_b` (kernel B) | `_fa_stream_kernel` |

The op `stablemtl::<op>` launches the kernel built from `csrc/<op>.cu`.

Each wrapper takes folded [batch*heads, S, d] tensors (the logsumexp and
delta rows as [batch*heads, S] f32) and calls its `torch.library` custom op
(`cuda_build.define_op`), which runs the plain version for CPU tensors,
launches the kernel for CUDA tensors (or raises) and counts the launch in
the wrapper's `launches` attribute, and gives shapes alone under a trace,
so `torch.export` records the op as one node. In bf16 all five are Hopper
kernels on TMA and `wgmma` (`csrc/sm90.cuh`): A and K3 share
`csrc/flash_fwd_a_sm90.cuh`, K4 and K5 `csrc/flash_bwd_sm90.cuh`; their
f32 instances are scalar checking kernels (`csrc/flash_fwd.cuh`,
`csrc/flash_common.cuh`). Each source notes what bounds it on the H100 and
how its design answers that.

`_Flash` and `_FlashStream` are the counterparts of the JAX package's
`_flash` and `_flash_stream` custom VJPs, taken only under autograd: the
resident path runs K3 and saves q, k, v, o and the logsumexp, and its
backward runs K4 and K5; the streaming path's backward is autograd of the
plain version, as in JAX (no training path differentiates it: the VAE runs
under no_grad). Without a gradient `flash_attention` calls kernel A's or
B's op directly.
"""

from __future__ import annotations

import torch

from ..utils.env import env_flag, reject_tpu_only_flags
from . import cuda_build

LOG2E = 1.4426950408889634  # the softmax runs in base 2
# fast-softmax guard: base-2 scores clamp to +-FAST_CLAMP, so a row with
# |logits| beyond ~76 nats flattens instead of overflowing exp2 to inf
FAST_CLAMP = 110.0
# the head dims each kernel has instances for: the presets' UNet heads and
# the tiny VAE's mid block (A, K3, K4, K5), the small and full VAE mid
# blocks (B)
RESIDENT_HEAD_DIMS = (16, 32, 64)  # kernel A family: accumulator in registers
STREAM_HEAD_DIMS = (256, 512)      # kernel B: output d split across warpgroups
RESIDENT_MAX_HEAD_DIM = 128        # larger head dims go to kernel B
_DTYPE_CODE = cuda_build.DTYPE_CODE


def fast_softmax() -> bool:
    """Drop the running max (p = exp2(clamp(s))): STABLEMTL_FLASH_FAST_SOFTMAX,
    defaulting to the STABLEMTL_FAST_MATH tier, as in the JAX package."""
    return env_flag("STABLEMTL_FLASH_FAST_SOFTMAX",
                    default=env_flag("STABLEMTL_FAST_MATH"))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def flash_forward_lse_reference(q, k, v, fast_softmax: bool):
    """Plain version of kernel A, K3 and kernel B on [BH, S, d]: base-2
    softmax of the f32 scores (clamped and max-free under fast_softmax),
    probabilities rounded to the input dtype for the P.V product, f32
    accumulation, o = acc / l. Returns (o, lse), lse [BH, S] f32 the base-2
    logsumexp m + log2(l) (log2(l) under fast softmax, where m = 0)."""
    scale2 = q.shape[-1] ** -0.5 * LOG2E
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale2
    if fast_softmax:
        m = torch.zeros(s.shape[:-1] + (1,), device=s.device)
        p = torch.exp2(s.clamp(-FAST_CLAMP, FAST_CLAMP))
    else:
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(q.dtype).float(), v.float())
    return (out / l).to(q.dtype), (m + torch.log2(l)).squeeze(-1)


def flash_reference(q, k, v, fast_softmax: bool):
    """The attention output of `flash_forward_lse_reference`."""
    return flash_forward_lse_reference(q, k, v, fast_softmax)[0]


def row_delta(do, o):
    """delta = rowsum(dO o O) in f32, [BH, S]: computed outside the backward
    kernels, as the JAX package computes it outside its Pallas kernels."""
    return (do.float() * o.float()).sum(dim=-1)


def _bwd_probs(q, k, v, do, lse, delta):
    """(P, dS) of the backward, f32 [BH, S, S]: P = exp2(s - lse) with no
    clamp (as the TPU kernels), dS = P o (dO V^T - delta)."""
    scale2 = q.shape[-1] ** -0.5 * LOG2E
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale2
    p = torch.exp2(s - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_reference(q, k, v, do, lse, delta):
    """Plain version of K4: dQ = d^-1/2 * dS K, dS rounded to the input
    dtype before its product, f32 accumulation, scaled at the end."""
    _, ds = _bwd_probs(q, k, v, do, lse, delta)
    dq = torch.matmul(ds.to(q.dtype).float(), k.float())
    return (dq * q.shape[-1] ** -0.5).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta):
    """Plain version of K5: dK = d^-1/2 * dS^T Q and dV = P^T dO, with P and
    dS rounded to the input dtype before their products."""
    p, ds = _bwd_probs(q, k, v, do, lse, delta)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), do.float())
    return (dk * q.shape[-1] ** -0.5).to(k.dtype), dv.to(v.dtype)


def flash_backward_reference(q, k, v, o, lse, do):
    """(dq, dk, dv) of the flash backward: the plain versions of K4 and K5
    with delta = rowsum(dO o O)."""
    delta = row_delta(do, o)
    return (flash_bwd_dq_reference(q, k, v, do, lse, delta),
            *flash_bwd_dkv_reference(q, k, v, do, lse, delta))


# ---------------------------------------------------------------------------
# Custom ops: one per kernel
# ---------------------------------------------------------------------------

def _check(entry: str, head_dims, xs, rows=()):
    """Raise unless the [BH, S, d] tensors `xs` share one device, shape and
    dtype, with d in head_dims, and the per-row tensors `rows` are [BH, S]
    f32 there; every tensor contiguous."""
    q = xs[0]
    if q.dim() != 3 or any(x.shape != q.shape for x in xs):
        raise ValueError(f"{entry}: tensors must share one [BH, S, d] shape: "
                         f"{[tuple(x.shape) for x in xs]}")
    if q.shape[-1] not in head_dims:
        raise ValueError(f"{entry}: head dim {q.shape[-1]} not in {head_dims}")
    if q.dtype not in _DTYPE_CODE or any(x.dtype != q.dtype for x in xs):
        raise ValueError(f"flash kernels take float32 or bfloat16 tensors; "
                         f"got {[x.dtype for x in xs]}")
    if any(r.shape != q.shape[:2] or r.dtype != torch.float32 for r in rows):
        raise ValueError(f"{entry}: per-row tensors must be [BH, S] float32")
    if any(x.device != q.device for x in (*xs, *rows)):
        raise ValueError(f"{entry}: tensors on different devices")
    if not all(x.is_contiguous() for x in (*xs, *rows)):
        raise ValueError("flash kernels take contiguous tensors")


def _shape_args(q):
    bh, s, d = q.shape
    return bh, s, d, _DTYPE_CODE[q.dtype]


def _forward(entry, head_dims, q, k, v, fast_softmax, want_lse=False):
    _check(entry, head_dims, (q, k, v))
    o = torch.empty_like(q)
    tensors = (q, k, v, o)
    if want_lse:
        lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
        tensors += (lse,)
    cuda_build.launch(entry, tensors, *_shape_args(q), int(fast_softmax),
                      q.shape[-1] ** -0.5 * LOG2E)
    return (o, lse) if want_lse else o


def _bwd_scalars(q):
    d = q.shape[-1]
    return (*_shape_args(q), d ** -0.5 * LOG2E, d ** -0.5)


def _fwd_a_cuda(q, k, v, fast):
    o = _forward("flash_fwd_a", RESIDENT_HEAD_DIMS, q, k, v, fast)
    cuda_build.count_launch(flash_fwd_resident)
    return o


def _fwd_lse_cuda(q, k, v, fast):
    out = _forward("flash_fwd_lse", RESIDENT_HEAD_DIMS, q, k, v, fast,
                          want_lse=True)
    cuda_build.count_launch(flash_fwd_resident_lse)
    return out


def _fwd_b_cuda(q, k, v, fast):
    o = _forward("flash_fwd_b", STREAM_HEAD_DIMS, q, k, v, fast)
    cuda_build.count_launch(flash_fwd_stream)
    return o


def _bwd_dq_cuda(q, k, v, do, lse, delta):
    _check("flash_bwd_dq", RESIDENT_HEAD_DIMS, (q, k, v, do), (lse, delta))
    dq = torch.empty_like(q)
    cuda_build.launch("flash_bwd_dq", (q, k, v, do, lse, delta, dq),
                      *_bwd_scalars(q))
    cuda_build.count_launch(flash_bwd_dq)
    return dq


def _bwd_dkv_cuda(q, k, v, do, lse, delta):
    _check("flash_bwd_dkv", RESIDENT_HEAD_DIMS, (q, k, v, do), (lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    cuda_build.launch("flash_bwd_dkv", (q, k, v, do, lse, delta, dk, dv),
                      *_bwd_scalars(q))
    cuda_build.count_launch(flash_bwd_dkv)
    return dk, dv


def _fwd_fake(q, k, v, fast):
    return q.new_empty(q.shape)


def _fwd_lse_fake(q, k, v, fast):
    return q.new_empty(q.shape), q.new_empty(q.shape[:2],
                                             dtype=torch.float32)


def _bwd_dq_fake(q, k, v, do, lse, delta):
    return q.new_empty(q.shape)


def _bwd_dkv_fake(q, k, v, do, lse, delta):
    return k.new_empty(k.shape), v.new_empty(v.shape)


_FWD = "(Tensor q, Tensor k, Tensor v, bool fast) -> "
_BWD = ("(Tensor q, Tensor k, Tensor v, Tensor do, Tensor lse, "
        "Tensor delta) -> ")
OPS = {
    "flash_fwd_a": cuda_build.define_op(
        "flash_fwd_a", _FWD + "Tensor", flash_reference, _fwd_a_cuda,
        _fwd_fake),
    "flash_fwd_lse": cuda_build.define_op(
        "flash_fwd_lse", _FWD + "(Tensor, Tensor)",
        flash_forward_lse_reference, _fwd_lse_cuda, _fwd_lse_fake),
    "flash_fwd_b": cuda_build.define_op(
        "flash_fwd_b", _FWD + "Tensor", flash_reference, _fwd_b_cuda,
        _fwd_fake),
    "flash_bwd_dq": cuda_build.define_op(
        "flash_bwd_dq", _BWD + "Tensor", flash_bwd_dq_reference,
        _bwd_dq_cuda, _bwd_dq_fake),
    "flash_bwd_dkv": cuda_build.define_op(
        "flash_bwd_dkv", _BWD + "(Tensor, Tensor)", flash_bwd_dkv_reference,
        _bwd_dkv_cuda, _bwd_dkv_fake),
}


# ---------------------------------------------------------------------------
# Kernel wrappers: each calls its op and holds its launch count
# ---------------------------------------------------------------------------

def _call(name, *args):
    """Op `name` on args; a tensor on neither the CPU nor CUDA raises (a
    meta tensor would reach the op's shape-only implementation)."""
    if args[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash kernels take CUDA or CPU tensors, got "
                         f"{args[0].device}")
    return OPS[name](*args)


def flash_fwd_resident(q, k, v, fast_softmax: bool):
    """Kernel A (op `stablemtl::flash_fwd_a`): attention on [BH, S, d] with
    d in RESIDENT_HEAD_DIMS."""
    return _call("flash_fwd_a", q, k, v, fast_softmax)


def flash_fwd_resident_lse(q, k, v, fast_softmax: bool):
    """K3 (op `stablemtl::flash_fwd_lse`): kernel A's output and the per-row
    base-2 logsumexp [BH, S] f32."""
    return _call("flash_fwd_lse", q, k, v, fast_softmax)


def flash_fwd_stream(q, k, v, fast_softmax: bool):
    """Kernel B (op `stablemtl::flash_fwd_b`): attention on [BH, S, d] with
    d in STREAM_HEAD_DIMS."""
    return _call("flash_fwd_b", q, k, v, fast_softmax)


def flash_bwd_dq(q, k, v, do, lse, delta):
    """K4 (op `stablemtl::flash_bwd_dq`): dQ [BH, S, d] from q, k, v, dO and
    the per-row lse and delta."""
    return _call("flash_bwd_dq", q, k, v, do, lse, delta)


def flash_bwd_dkv(q, k, v, do, lse, delta):
    """K5 (op `stablemtl::flash_bwd_dkv`): (dK, dV) [BH, S, d] from q, k, v,
    dO and the per-row lse and delta."""
    return _call("flash_bwd_dkv", q, k, v, do, lse, delta)


KERNELS = (flash_fwd_resident, flash_fwd_stream, flash_fwd_resident_lse,
           flash_bwd_dq, flash_bwd_dkv)
for _kernel in KERNELS:
    _kernel.launches = 0


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------

class _Flash(torch.autograd.Function):
    """Resident flash attention on [BH, S, d] under autograd: the forward is
    K3 and saves q, k, v, o and the logsumexp; the backward computes
    delta = rowsum(dO o O) in f32, then dQ (K4) and dK, dV (K5). Under
    activation recompute (`models/unet.py`) the forward runs again in the
    backward, K3 included: the "dots" policy keeps only matrix products'
    outputs, and a custom op is not one."""

    @staticmethod
    def forward(ctx, q, k, v, fast: bool):
        o, lse = flash_fwd_resident_lse(q, k, v, fast)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = row_delta(do, o)
        dq = flash_bwd_dq(q, k, v, do, lse, delta)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta)
        return dq, dk, dv, None


class _FlashStream(torch.autograd.Function):
    """Streaming flash attention (kernel B) under autograd. Its backward
    differentiates the plain exact-softmax version, as JAX's
    `_flash_stream` does."""

    @staticmethod
    def forward(ctx, q, k, v, fast: bool):
        ctx.save_for_backward(q, k, v)
        return flash_fwd_stream(q, k, v, fast)

    @staticmethod
    def backward(ctx, do):
        with torch.enable_grad():
            qkv = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            o = flash_reference(*qkv, fast_softmax=False)
        return (*torch.autograd.grad(o, qkv, do), None)


def flash_attention(q, k, v):
    """Self-attention [B, S, H, d] -> [B, S, H, d] through the kernels that
    fit the head dim: up to 128 the output accumulator fits registers
    (kernel A, or K3/K4/K5 under autograd); beyond, kernel B splits it
    across the warpgroups of a CTA. On the card a head dim the kernel has no
    instance of raises."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_attention needs q, k, v of one [B, S, H, d] "
                         "shape")
    if q.is_cuda:
        reject_tpu_only_flags()
    b, s, h, d = q.shape

    def fold(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()

    args = (fold(q), fold(k), fold(v), fast_softmax())
    resident = d <= RESIDENT_MAX_HEAD_DIM
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        out = (_Flash if resident else _FlashStream).apply(*args)
    else:  # the op itself, so a trace records it
        out = (flash_fwd_resident if resident else flash_fwd_stream)(*args)
    return out.view(b, h, s, d).permute(0, 2, 1, 3)
