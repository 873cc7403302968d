"""mfu.train: the whole training micro-step's share of the card's bf16
peak: FLOPs an image of a micro-step (VAE encodes and the child without
gradients, the main UNet's forward and backward, no recompute; counted
on the plain reference, workcount/count.py) times the window's images/s
over 989 TFLOP/s."""

from bench_port.workcount.peaks import PEAK_BF16_FLOPS


def read(record):
    if record.get("kind") != "train":
        return None
    return 100.0 * record["flops_per_image"] * record["images_per_s"] \
        / PEAK_BF16_FLOPS
