"""Training losses and loss weighting. Counterpart of
`stablemtl_tpu/utils/loss.py` (parity with the reference's
src/util/loss.py): an explicit valid mask instead of boolean indexing, and
a masked mean sum(x * m) / max(sum(m), 1)."""

from __future__ import annotations

import torch


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


def l1_loss(pred, target, valid_mask=None):
    """Mean absolute error, over the valid elements when a mask is given."""
    ab = (pred - target).abs()
    if valid_mask is None:
        return ab.mean()
    return masked_mean(ab, valid_mask)


def _masked_diff(diff, target, valid_mask):
    """(diff zeroed outside the mask, the valid count per image [..., H, W]
    -> [...]); H * W without a mask."""
    if valid_mask is None:
        return diff, target.shape[-2] * target.shape[-1]
    return torch.where(valid_mask, diff, 0.0), valid_mask.sum((-1, -2))


def l1_loss_with_mask(pred, target, valid_mask=None, batch_reduction=False):
    """Sum of the masked absolute error over the valid count of each image
    (one value per image; their mean under batch_reduction)."""
    diff, n = _masked_diff(pred - target, target, valid_mask)
    loss = diff.abs().sum() / n
    if batch_reduction:
        loss = loss.mean()
    return loss


def mean_abs_rel_loss(pred, target, valid_mask=None):
    """|pred - target| / target averaged over the batch axis; valid_mask is
    taken for the uniform get_loss convention and ignored, as the
    reference's MeanAbsRelLoss does."""
    return ((pred - target) / target).abs().mean(dim=0)


def _silog_terms(pred, target, valid_mask, lamb, log_pred, clip):
    log_p = pred if log_pred else torch.log(
        pred.clamp(min=1e-8) if clip else pred)
    diff, n = _masked_diff(log_p - torch.log(target), target, valid_mask)
    first = (diff ** 2).sum((-1, -2)) / n
    second = lamb * diff.sum((-1, -2)) ** 2 / (n ** 2)
    return first - second


def silog_mse_loss(pred, target, valid_mask=None, lamb=0.5, log_pred=True,
                   batch_reduction=True):
    """Scale-invariant log error per image (its mean under
    batch_reduction)."""
    loss = _silog_terms(pred, target, valid_mask, lamb, log_pred, clip=True)
    if batch_reduction:
        loss = loss.mean()
    return loss


def silog_rmse_loss(pred, target, valid_mask=None, lamb=0.5, alpha=10.0,
                    log_pred=True):
    """alpha * the batch mean of the per-image root scale-invariant log
    error."""
    loss = _silog_terms(pred, target, valid_mask, lamb, log_pred, clip=False)
    return loss.sqrt().mean() * alpha


_LOSSES = {
    "mse_loss": mse_loss,
    "l1_loss": l1_loss,
    "l1_loss_with_mask": l1_loss_with_mask,
    "mean_abs_rel": mean_abs_rel_loss,
    "silog_mse": silog_mse_loss,
    "silog_rmse": silog_rmse_loss,
}


def get_loss(loss_name: str, **kwargs):
    """loss_fn(pred, target, valid_mask) of `loss_name`, closing over the
    extra kwargs (a `reduction` key is dropped)."""
    if loss_name not in _LOSSES:
        raise NotImplementedError(loss_name)
    fn = _LOSSES[loss_name]
    kwargs = {k: v for k, v in kwargs.items() if k != "reduction"}

    def wrapped(pred, target, valid_mask=None):
        return fn(pred, target, valid_mask=valid_mask, **kwargs)

    return wrapped


class MovingAverageLossWeighter:
    """EMA-magnitude loss balancer, on the host (parity with the
    reference's loss.py:4-67, which builds it but never applies its
    weights to the training loss)."""

    def __init__(self, loss_names, min_weight=0.2, max_weight=5.0,
                 alpha=0.98, epsilon=1e-8):
        self.alpha = alpha
        self.epsilon = epsilon
        self.min_weight = min_weight
        self.max_weight = max_weight
        self.ema = {n: 1.0 for n in loss_names}
        self.first = {n: True for n in loss_names}

    def __call__(self, loss_dict):
        for name, val in loss_dict.items():
            v = float(val)
            if self.first[name]:
                self.ema[name] = v
                self.first[name] = False
            else:
                self.ema[name] = (self.alpha * self.ema[name]
                                  + (1 - self.alpha) * v)
        if any(self.first.values()):
            return {n: 1.0 for n in loss_dict}
        avg = sum(self.ema.values()) / len(self.ema)
        return {n: min(max(avg / max(self.ema[n], self.epsilon),
                           self.min_weight), self.max_weight)
                for n in loss_dict}
