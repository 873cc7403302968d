"""What every kind does after its window: the traced stretch's record,
and the plain reference run on the same inputs once the program is
freed."""

from __future__ import annotations

import gc

import torch

from . import cells
from . import device as card
from . import program
from .check import worst_rel_l2
from .trace import profiled


def trace_record(ctx, fn, window_s=None, **fields) -> dict:
    """{"trace": the profiler's record of fn(), **fields}; logs the traced
    stretch's two times beside window_s, the window's time for as much
    work."""
    tr = profiled(fn)
    beside = "" if window_s is None else f"; the window {window_s:.3f} s"
    ctx.log(f"traced stretch {tr['window_s']:.3f} s recording the device, "
            f"{tr['host_traced_window_s']:.3f} s with the host{beside}")
    return {"trace": tr, **fields}


def plain_float32() -> None:
    """The reference's products in true float32: no TF32 in matmuls or
    cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def plain_reference(config: dict, seed: int, device,
                    trainable: bool = False):
    """The plain reference the configuration names, with the seed's
    weights (drawn as the program's were: `trainable`, the main UNet's in
    float32) and conditioning, on `device`."""
    plain = cells.reference_of(config)
    weights = program.draw_weights(config, seed, device,
                                   program.weight_dtypes(config, trainable))
    return plain.Reference.from_weights(
        config, weights, plain.conditioning(config, seed, device), device)


def reference(ctx, trainable: bool = False):
    """The cell's `plain_reference` with the run's seed, on the card, in
    true float32, once the program's memory is returned."""
    gc.collect()
    card.empty_cache(ctx.device)
    plain_float32()
    return plain_reference(ctx.cell.config, ctx.seed, ctx.device, trainable)


def rel_l2_check(ctx, produced, images) -> float:
    """The worst relative L2 gap between the program's all-task maps
    `produced` [7, B, H, W, 3] and the reference's of host images [B, H,
    W, 3]."""
    ref = reference(ctx)
    x = torch.from_numpy(images).to(ctx.device)
    want = ref.infer_all_tasks(x, None).cpu().numpy()
    gap = worst_rel_l2(produced, want)
    ctx.log(f"worst relative L2 gap to the reference {gap!r}")
    return gap
