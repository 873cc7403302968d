"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit), frozen here from the repository's
`chip_smoke.py` (PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES,
PEAK_FP32_INSTR, PEAK_EXP2, POLY_FP32_OPS). A card set below 700 W runs
under them: the run prints its power limit beside them."""

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# FP32 instructions a second outside the tensor cores: the data sheet's
# FP32 rate counts an FMA as 2 FLOPs (128 lanes an SM, 132 SMs, at the
# 1.98 GHz boost clock that rate implies); the special-function units'
# exp2 runs at 16 a clock an SM, an eighth of it
PEAK_FP32_INSTR = PEAK_F32_FLOPS / 2
PEAK_EXP2 = PEAK_FP32_INSTR / 8
# FP32 instructions a score of the flash kernels' polynomial exp2, by
# degree
POLY_FP32_OPS = {3: 8, 4: 9}
