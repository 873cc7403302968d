"""The arithmetic of the plain reference: every matrix product and
convolution goes through the functions below.

In the default mode they are plain float32 products (the caller turns
TF32 off on the card). Under `precision("fp8")` both operands of every
product are first rounded to float8 e4m3 with one scale per tensor
(amax / 448), and in a backward the gradient reaching them to e5m2
(amax / 57344), the products still summed in float32, as fp8 tensor
cores do: that is the control of the output check, the reference
computed one precision below the configuration's bfloat16.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

_MODE = contextvars.ContextVar("bench_port_precision", default="f32")
# a list that `attention` appends each call's (heads * batch, queries,
# keys, head dim, whether a gradient flows back through it) to, while
# `recording` holds it
_CALLS = contextvars.ContextVar("bench_port_attention_calls", default=None)
E4M3_MAX = 448.0
E5M2_MAX = 57344.0
MODES = ("f32", "fp8")


@contextlib.contextmanager
def precision(mode: str):
    """Products inside the block run in `mode` ("f32" or "fp8")."""
    if mode not in MODES:
        raise ValueError(f"precision {mode!r} is not one of {MODES}")
    token = _MODE.set(mode)
    try:
        yield
    finally:
        _MODE.reset(token)


@contextlib.contextmanager
def recording(calls: list):
    """Within the block, every attention call appends its shape to
    `calls`."""
    token = _CALLS.set(calls)
    try:
        yield calls
    finally:
        _CALLS.reset(token)


def note_attention(bh: int, sq: int, sk: int, d: int, grad: bool) -> None:
    calls = _CALLS.get()
    if calls is not None:
        calls.append((bh, sq, sk, d, bool(grad)))


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to the fp8 `dtype` under one scale (amax / top)."""
    amax = x.abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / scale).to(dtype).to(x.dtype) * scale


class _FP8(torch.autograd.Function):
    """An operand of a product rounded to e4m3 on the way in, and the
    gradient that comes back to it to e5m2, each with a scale of its own:
    fp8 products in the forward and the backward."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def q(x: torch.Tensor) -> torch.Tensor:
    """x as the products see it: itself, or rounded to fp8 (`_FP8`)."""
    if _MODE.get() != "fp8" or x.device.type == "meta":
        return x
    return _FP8.apply(x)


def linear(x, w, b=None):
    return F.linear(q(x), q(w), b)


def conv2d(x, w, b=None, stride=1, padding=0):
    return F.conv2d(q(x), q(w), b, stride=stride, padding=padding)


def matmul(a, b):
    return torch.matmul(q(a), q(b))


def einsum(eq, a, b):
    return torch.einsum(eq, q(a), q(b))


def upsample_conv(x, w, b, size=None):
    """Nearest upsampling of x [B, C, H, W] to `size` (2x when None), then
    a 3x3 'same' conv. On the meta device, where only the work is counted,
    an exact 2x takes the form that needs the least of it: a stride-2
    transposed conv with a 4x4 kernel, 4 taps an output pixel where the
    upsampled map costs 9."""
    h, wd = x.shape[2:]
    size = (2 * h, 2 * wd) if size is None else tuple(size)
    if x.device.type == "meta" and size == (2 * h, 2 * wd):
        w4 = w.new_empty((w.shape[1], w.shape[0], 4, 4))
        return F.conv_transpose2d(x, w4, b, stride=2, padding=1)
    return conv2d(F.interpolate(x, size=size, mode="nearest"), w, b,
                  padding=1)
