"""Training losses. Counterpart of the masked losses of
`stablemtl_tpu/utils/loss.py`: an explicit valid mask, and a masked mean
sum(x * m) / max(sum(m), 1)."""

from __future__ import annotations


def masked_mean(x, mask, count=None):
    """sum(x * mask) / max(sum(mask), 1); mask has x's shape. count: the
    divisor's sum(mask) when x holds one rank's rows of a global batch
    (the mask count over all ranks)."""
    mask = mask.to(x.dtype)
    if count is None:
        count = mask.sum()
    return (x * mask).sum() / count.clamp(min=1.0)


def mse_loss(pred, target, valid_mask=None):
    """Mean squared error, over the valid elements when a mask is given."""
    sq = (pred - target) ** 2
    if valid_mask is None:
        return sq.mean()
    return masked_mean(sq, valid_mask)
