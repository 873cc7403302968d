"""Flash-attention forward: two hand-written Hopper kernels and their plain
version.

Kernel A (`flash_fwd_resident`) replaces the TPU kernel
`stablemtl_tpu/ops/flash_attention.py::_fa_kernel_nolse` (UNet
self-attention, head dim 64). Kernel B (`flash_fwd_stream`) replaces
`_fa_stream_kernel` (the VAE mid-block attention: one head of dim 512).
`flash_reference` is the plain PyTorch version of the function both
compute, used for CPU tensors and as the yardstick the kernels are held
against on the card.

Each wrapper takes folded [batch*heads, S, d] tensors, runs the plain
version for a tensor on the CPU, launches its kernel for a CUDA tensor (or
raises), and counts its launches in its `launches` attribute. Kernel A's
source is `csrc/flash_fwd_a.cu`, kernel B's `csrc/flash_fwd_b.cu`; the
kernel they share, with its note on what bounds it on the H100 and how the
design answers it, is `csrc/flash_fwd.cuh`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.env import env_flag, reject_tpu_only_flags
from . import cuda_build

LOG2E = 1.4426950408889634  # the softmax runs in base 2
# fast-softmax guard: base-2 scores clamp to +-FAST_CLAMP, so a row with
# |logits| beyond ~76 nats flattens instead of overflowing exp2 to inf
FAST_CLAMP = 110.0
# the head dims each kernel has instances for: the presets' UNet heads and
# the tiny VAE's mid block (A), the small and full VAE mid blocks (B)
RESIDENT_HEAD_DIMS = (16, 32, 64)  # kernel A: accumulator in registers
STREAM_HEAD_DIMS = (256, 512)      # kernel B: output d split across CTAs
RESIDENT_MAX_HEAD_DIM = 128        # larger head dims go to kernel B
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fast_softmax() -> bool:
    """Drop the running max (p = exp2(clamp(s))): STABLEMTL_FLASH_FAST_SOFTMAX,
    defaulting to the STABLEMTL_FAST_MATH tier, as in the JAX package."""
    return env_flag("STABLEMTL_FLASH_FAST_SOFTMAX",
                    default=env_flag("STABLEMTL_FAST_MATH"))


def flash_reference(q, k, v, fast_softmax: bool):
    """Plain version of both kernels on [BH, S, d]: base-2 softmax of the f32
    scores (clamped and max-free under fast_softmax), probabilities rounded
    to the input dtype for the P.V product, f32 accumulation, o = acc / l."""
    scale2 = q.shape[-1] ** -0.5 * LOG2E
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale2
    if fast_softmax:
        p = torch.exp2(s.clamp(-FAST_CLAMP, FAST_CLAMP))
    else:
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    out = torch.matmul(p.to(q.dtype).float(), v.float())
    return (out / p.sum(dim=-1, keepdim=True)).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """(entry point, error-string function) of library `name`, whose entry
    point is `smtl_<name>`."""
    lib = cuda_build.load(name)
    fn = getattr(lib, f"smtl_{name}")
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.smtl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.smtl_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.smtl_cuda_error_string


def _launch(entry: str, head_dims, q, k, v, fast_softmax: bool):
    if q.device.type != "cuda":
        raise ValueError(f"flash kernels take CUDA or CPU tensors, "
                         f"got {q.device}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [BH, S, d] shape: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if q.shape[-1] not in head_dims:
        raise ValueError(f"{entry}: head dim {q.shape[-1]} not in {head_dims}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernels take float32 or bfloat16 q, k, v; "
                         f"got {q.dtype} {k.dtype} {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernels take contiguous q, k, v")
    bh, s, d = q.shape
    o = torch.empty_like(q)
    fn, error_string = _entry(entry)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, s, d,
             _DTYPE_CODE[q.dtype], int(fast_softmax), d ** -0.5 * LOG2E,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{error_string(err).decode()}")
    return o


def flash_fwd_resident(q, k, v, fast_softmax: bool):
    """Kernel A: attention on [BH, S, d] with d in RESIDENT_HEAD_DIMS."""
    if q.device.type == "cpu":
        return flash_reference(q, k, v, fast_softmax)
    o = _launch("flash_fwd_a", RESIDENT_HEAD_DIMS, q, k, v, fast_softmax)
    flash_fwd_resident.launches += 1
    return o


def flash_fwd_stream(q, k, v, fast_softmax: bool):
    """Kernel B: attention on [BH, S, d] with d in STREAM_HEAD_DIMS."""
    if q.device.type == "cpu":
        return flash_reference(q, k, v, fast_softmax)
    o = _launch("flash_fwd_b", STREAM_HEAD_DIMS, q, k, v, fast_softmax)
    flash_fwd_stream.launches += 1
    return o


flash_fwd_resident.launches = 0
flash_fwd_stream.launches = 0


def flash_attention(q, k, v):
    """Self-attention [B, S, H, d] -> [B, S, H, d] through the kernel that
    fits the head dim: up to 128 the output accumulator fits registers
    (kernel A); beyond, kernel B splits it across CTAs. On the card a head
    dim the kernel has no instance of raises."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_attention needs q, k, v of one [B, S, H, d] "
                         "shape")
    if q.is_cuda:
        reject_tpu_only_flags()
    b, s, h, d = q.shape

    def fold(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()

    kernel = (flash_fwd_resident if d <= RESIDENT_MAX_HEAD_DIM
              else flash_fwd_stream)
    out = kernel(fold(q), fold(k), fold(v), fast_softmax())
    return out.view(b, h, s, d).permute(0, 2, 1, 3)
