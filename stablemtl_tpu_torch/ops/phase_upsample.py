"""Nearest-2x upsample + 3x3 'same' conv as ONE stride-2 transposed conv.

On the high-res grid every output pixel's 3x3 window covers at most 2x2
distinct low-res pixels, so the composition is exactly a stride-2
transposed convolution of the low-res input with a 4x4 kernel whose taps
are sums of the 3x3 taps that alias to the same low-res pixel (per axis:
w4 = [K0, K0+K1, K1+K2, K2]). No 4x-inflated intermediate is materialized.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# rows of the 3x3 kernel that contribute to each of the 4 taps, per axis
_GROUPS = ((0,), (0, 1), (1, 2), (2,))


def upsample_conv_kernel(w3: torch.Tensor) -> torch.Tensor:
    """[Cout, Cin, 3, 3] 'same'-conv weight -> the [Cout, Cin, 4, 4]
    correlation kernel of (nearest 2x, then w3) over the 2x-dilated input."""
    return torch.stack([
        torch.stack([sum(w3[:, :, ky, kx] for ky in _GROUPS[a]
                         for kx in _GROUPS[b]) for b in range(4)], dim=-1)
        for a in range(4)], dim=-2)


def upsample2x_conv3x3(x, weight, bias=None):
    """x [B, Cin, H, W]; weight [Cout, Cin, 3, 3]; bias [Cout] or None.
    Returns [B, Cout, 2H, 2W] = conv3x3(nearest_upsample_2x(x))."""
    k4 = upsample_conv_kernel(weight.to(x.dtype))
    # conv_transpose2d correlates the dilated input with the flipped,
    # in/out-swapped kernel and pads by k - 1 - padding = 2
    wt = k4.flip(2, 3).transpose(0, 1)
    return F.conv_transpose2d(
        x, wt, None if bias is None else bias.to(x.dtype), stride=2,
        padding=1)
