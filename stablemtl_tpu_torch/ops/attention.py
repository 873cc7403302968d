"""Scaled-dot-product attention dispatch.

Shapes are [batch, seq, heads, head_dim] (BSHD), bias broadcastable to
[batch, heads, q_seq, kv_seq]. Long self-attention on the card goes to the
flash kernels (ops/flash_attention.py), whatever its head dim; everything
else (text cross-attention, short sequences, the CPU) runs the plain math
below.
"""

from __future__ import annotations

import torch

from ..utils.env import env_flag
from .flash_attention import flash_attention

# below this sequence length plain attention is used
FLASH_MIN_SEQ = 1024


def plain_attention(q, k, v, bias=None):
    """f32 logits and softmax, probabilities cast to the input dtype, P.V
    accumulated in f32, result in the input dtype."""
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    qh, kh, vh = (x.permute(0, 2, 1, 3).float() for x in (q, k, v))
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(dtype).float(), vh)
    return out.permute(0, 2, 1, 3).to(dtype)


def use_flash(q, k, bias=None) -> bool:
    return (q.shape[1] >= FLASH_MIN_SEQ and q.shape[1] == k.shape[1]
            and bias is None and q.is_cuda
            and not env_flag("STABLEMTL_DISABLE_FLASH"))


def dot_product_attention(q, k, v, bias=None):
    """Attention [B, Sq, H, d] x [B, Sk, H, d] -> [B, Sq, H, d]."""
    if use_flash(q, k, bias):
        return flash_attention(q, k, v)
    return plain_attention(q, k, v, bias)
