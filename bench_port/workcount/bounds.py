"""Least time of one kernel call: the larger of its bytes over HBM
bandwidth and its operations over their peak. Frozen copies of
`chip_smoke.py`'s `attention_bound_ms` and `geglu_bound_ms`, with the
dtype given by name so that nothing here needs a tensor."""

from __future__ import annotations

from .peaks import (PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_EXP2, PEAK_F32_FLOPS,
                    PEAK_FP32_INSTR, POLY_FP32_OPS)

ITEM = {"bfloat16": 2, "float16": 2, "float32": 4}
# (FLOPs a score and head dim, [bh, s, d] tensors, [bh, s] f32 rows) of
# each flash kernel: the forward (K1, K2), the forward with its
# logsumexp (K3), dQ (K4) and dK, dV (K5)
FLASH = {"fwd": (4, 4, 0), "fwd_lse": (4, 4, 1), "bwd_dq": (6, 5, 2),
         "bwd_dkv": (8, 6, 2)}


def attention_bound_ms(bh: int, s: int, d: int, dtype: str = "bfloat16",
                       flops: int = 4, tensors: int = 4, rows: int = 0,
                       poly: int = 0) -> tuple:
    """(ms, "bytes" or "operations") for a flash kernel on [bh, s, d]:
    `tensors` [bh, s, d] tensors and `rows` [bh, s] f32 vectors each read
    or written once, flops*s*s*d FLOPs and s*s exp2 a head (a polynomial
    variant's FP32 operations in place of the exp2)."""
    t_bytes = (tensors * bh * s * d * ITEM[dtype] + rows * bh * s * 4) \
        / PEAK_BYTES
    peak = PEAK_BF16_FLOPS if ITEM[dtype] == 2 else PEAK_F32_FLOPS
    t_exp = (bh * s * s * POLY_FP32_OPS[poly] / PEAK_FP32_INSTR if poly
             else bh * s * s / PEAK_EXP2)
    t_ops = max(flops * d * bh * s * s / peak, t_exp)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def flash_bound_ms(kind: str, bh: int, s: int, d: int,
                   dtype: str = "bfloat16") -> float:
    flops, tensors, rows = FLASH[kind]
    return attention_bound_ms(bh, s, d, dtype, flops, tensors, rows)[0]


def geglu_bound_ms(shape, dtype: str = "bfloat16") -> tuple:
    """(ms, bound) for the fused GEGLU (K6) on (R, C, F): x, W, b read
    once, y written once; 4*R*C*F FLOPs."""
    r, c, f = shape
    t_bytes = (r * c + 2 * f * c + 2 * f + r * f) * ITEM[dtype] / PEAK_BYTES
    peak = PEAK_BF16_FLOPS if ITEM[dtype] == 2 else PEAK_F32_FLOPS
    t_ops = 4 * r * c * f / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")
