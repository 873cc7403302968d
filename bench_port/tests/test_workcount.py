"""The FLOP and attention-shape count of workcount/ against hand sums,
and the frozen bounds against the arithmetic they copy."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port.reference.model import Decoder, ResnetBlock, Transformer2D
from bench_port.reference.model import UNetSpec, VAESpec
from bench_port.reference.precision import recording
from bench_port.workcount import bounds, peaks


def count(fn):
    calls = []
    with FlopCounterMode(display=False) as c, recording(calls):
        fn()
    return c.get_total_flops(), calls


def test_unet_block_flops_and_attention_shapes():
    """SD2's first down block layer: a 320-channel resnet and transformer
    at 64x64 latents (4096 tokens, 5 heads of 64), text of 4 tokens."""
    B, C, H, W, L, D, heads, T = 2, 320, 64, 64, 4, 1024, 5, 1280
    N = H * W
    with torch.device("meta"):
        res = ResnetBlock(C, C, T)
        tr = Transformer2D(C, heads, D, False, UNetSpec())
        x = torch.empty(B, C, H, W)
        temb = torch.empty(B, T)
        ctx = torch.empty(B, L, D)

    def block():
        h = res(x, temb)
        hp, a1 = tr.front(h)
        tr.back(h, hp, a1, ctx, None, None)

    flops, calls = count(block)
    conv3 = 2 * B * N * C * C * 9
    hand = (2 * conv3 + 2 * B * T * C                  # resnet
            + 2 * B * N * C * C                         # proj_in
            + 3 * 2 * B * N * C * C                     # q, k, v
            + 2 * 2 * B * heads * N * N * (C // heads)  # scores, p.v
            + 2 * B * N * C * C                         # attn1 out
            + 2 * B * N * C * C + 2 * 2 * B * L * D * C  # attn2 q, k, v
            + 2 * 2 * B * heads * N * L * (C // heads)  # scores, p.v
            + 2 * B * N * C * C                         # attn2 out
            + 2 * B * N * C * 8 * C + 2 * B * N * 4 * C * C  # GEGLU, net_2
            + 2 * B * N * C * C)                        # proj_out
    assert flops == hand
    # a gradient flows back: the modules' parameters are trainable
    assert calls == [(B * heads, N, N, C // heads, True),
                     (B * heads, N, L, C // heads, True)]


def test_vae_up_block_flops():
    """The decoder's second up block: three 512-channel resnets at 128x128
    and the 2x upsampling conv, counted as the 4x4 transposed conv it
    needs (4 taps an output pixel, not 9)."""
    B, C, H, W = 1, 512, 128, 128
    with torch.device("meta"):
        dec = Decoder(VAESpec())
        x = torch.empty(B, C, H, W)

    def up_block():
        h = x
        for j in range(3):
            h = getattr(dec, f"up_blocks_1_resnets_{j}")(h)
        dec.up_blocks_1_upsamplers_0_conv(h)

    flops, calls = count(up_block)
    hand = 3 * 2 * (2 * B * H * W * C * C * 9) + 2 * B * (2 * H) * (2 * W) \
        * C * C * 4
    assert flops == hand and calls == []


def test_bounds_copy_the_smoke_tests_arithmetic():
    # PERF.md's kernel table: K1 at [35,4096,64] bf16 0.1520 ms
    # (operations), K6 at the batch-2 serving shape 0.0950 ms
    ms, what = bounds.attention_bound_ms(35, 4096, 64)
    assert round(ms, 4) == 0.1520 and what == "operations"
    ms, _ = bounds.geglu_bound_ms((57344, 320, 1280))
    assert round(ms, 4) == 0.0950
    assert peaks.PEAK_EXP2 == 67e12 / 2 / 8
    k4 = bounds.flash_bound_ms("bwd_dq", 10, 1728, 64)
    assert round(k4, 4) == 0.0116
