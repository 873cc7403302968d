// K3: the flash-attention forward of the training path (UNet self-attention
// under autograd, head dim 64 at SD2 width), which also writes each row's
// base-2 logsumexp. Replaces stablemtl_tpu/ops/flash_attention.py::
// _fa_kernel with its lse output (reached through _flash_fwd). The backward
// kernels read the logsumexp as [bh, s] f32: m + log2(l), or log2(l) under
// FAST, where m = 0 (the TPU kernel stores it lane-replicated, a TPU tiling
// artifact).
//
// bf16 runs kernel A's Hopper template (flash_fwd_a_sm90.cuh: TMA ring,
// wgmma, warp-specialised consumers; its design and bound are written
// there) with LSE on and three consumers: at the training shape
// [10, 1728, 64] 90 CTAs of 192 rows fit one wave on 132 SMs, where 140 of
// 128 rows take two (PERF.md has both counts' times). What bounds it
// there: 4 * 1728^2 * 64 * 10 = 7.6e9 FLOPs, 7.7 us at 989 TFLOP/s, and as
// many microseconds of exp2; q, k, v, o and lse once are 8.9 MB, 2.7 us.
// float32 inputs run the first-version template of flash_fwd.cuh (checks
// only).

#include "flash_fwd.cuh"
#include "flash_fwd_a_sm90.cuh"

namespace {

// d in {16, 32, 64}, as kernel A. f32: one d_v chunk, 64-key tiles.
int launch_lse(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int s, int d, int dtype, float scale2,
               int fast, cudaStream_t st) {
  if (dtype == 1) {
    if (d == 16)
      return launch_a_sm90<16, 3, true>(q, k, v, o, lse, bh, s, scale2,
                                        fast, st);
    if (d == 32)
      return launch_a_sm90<32, 3, true>(q, k, v, o, lse, bh, s, scale2,
                                        fast, st);
    if (d == 64)
      return launch_a_sm90<64, 3, true>(q, k, v, o, lse, bh, s, scale2,
                                        fast, st);
  } else if (dtype == 0) {
    if (d == 16)
      return launch_mode<16, 16, 64, true>(q, k, v, o, bh, s, scale2, fast,
                                           st, lse);
    if (d == 32)
      return launch_mode<32, 32, 64, true>(q, k, v, o, bh, s, scale2, fast,
                                           st, lse);
    if (d == 64)
      return launch_mode<64, 64, 64, true>(q, k, v, o, bh, s, scale2, fast,
                                           st, lse);
  }
  return kBadArgument;
}

}  // namespace

extern "C" int smtl_flash_fwd_lse(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int bh, int s, int d,
                                  int dtype, int fast, float scale2,
                                  void* stream) {
  return launch_lse(q, k, v, o, lse, bh, s, d, dtype, scale2, fast,
                    static_cast<cudaStream_t>(stream));
}
