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
// there: 4 * 1728^2 * 64 * 10 = 7.6e9 FLOPs, 7.7 us at 989 TFLOP/s, and 7.1 us
// of exp2; q, k, v, o and lse once are 8.9 MB, 2.7 us.
// float32 inputs run the first-version template of flash_fwd.cuh (checks
// only).
//
// The JAX package's variants (STABLEMTL_FLASH_POLY_EXP, _MXU_LSUM) are
// kernel A's (flash_fwd_a_sm90.cuh); their logsumexp is the variant's
// m + log2(l), which the backward reads as it reads the default's, exp2
// exact there as in the JAX package. Built in parts as flash_fwd_a.cu.

#include "flash_fwd.cuh"
#include "flash_fwd_a_sm90.cuh"

namespace smtl {

// The instances of one variant: d in {16, 32, 64}, as kernel A. f32: one
// d_v chunk, 64-key tiles, no LSUM instance (the caller passes lsum 0).
template <int POLY, bool LSUM>
int launch_lse(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int s, int d, int dtype, float scale2,
               int fast, cudaStream_t st) {
  if (dtype == 1) {
    if (d == 16)
      return launch_a_sm90<16, 3, true, POLY, LSUM>(q, k, v, o, lse, bh, s,
                                                    scale2, fast, st);
    if (d == 32)
      return launch_a_sm90<32, 3, true, POLY, LSUM>(q, k, v, o, lse, bh, s,
                                                    scale2, fast, st);
    if (d == 64)
      return launch_a_sm90<64, 3, true, POLY, LSUM>(q, k, v, o, lse, bh, s,
                                                    scale2, fast, st);
  } else if constexpr (!LSUM) {
    if (dtype == 0 && d == 16)
      return launch_mode<16, 16, RESIDENT_F32_BN, true, POLY>(
          q, k, v, o, bh, s, scale2, fast, st, lse);
    if (dtype == 0 && d == 32)
      return launch_mode<32, 32, RESIDENT_F32_BN, true, POLY>(
          q, k, v, o, bh, s, scale2, fast, st, lse);
    if (dtype == 0 && d == 64)
      return launch_mode<64, 64, RESIDENT_F32_BN, true, POLY>(
          q, k, v, o, bh, s, scale2, fast, st, lse);
  }
  return kBadArgument;
}

}  // namespace smtl

#define SMTL_LAUNCH_LSE_ARGS                                                \
  const void*, const void*, const void*, void*, void*, int, int, int, int, \
      float, int, cudaStream_t

// A variant's part (SMTL_POLY and SMTL_LSUM defined, ops/cuda_build.py's
// PARTS) instantiates that variant; the source without defines holds the
// entry point and the default's instances.
#ifdef SMTL_POLY
template int smtl::launch_lse<SMTL_POLY, (SMTL_LSUM != 0)>(
    SMTL_LAUNCH_LSE_ARGS);
#else
extern template int smtl::launch_lse<0, true>(SMTL_LAUNCH_LSE_ARGS);
extern template int smtl::launch_lse<3, false>(SMTL_LAUNCH_LSE_ARGS);
extern template int smtl::launch_lse<3, true>(SMTL_LAUNCH_LSE_ARGS);
extern template int smtl::launch_lse<4, false>(SMTL_LAUNCH_LSE_ARGS);
extern template int smtl::launch_lse<4, true>(SMTL_LAUNCH_LSE_ARGS);

// poly in {0, 3, 4}, lsum in {0, 1} (dropped for f32); any other variant
// returns kBadVariant.
extern "C" int smtl_flash_fwd_lse(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int bh, int s, int d,
                                  int dtype, int fast, int poly, int lsum,
                                  float scale2, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const bool sum = lsum != 0 && dtype != 0;
  if (poly == 0)
    return sum ? smtl::launch_lse<0, true>(q, k, v, o, lse, bh, s, d, dtype,
                                           scale2, fast, st)
               : smtl::launch_lse<0, false>(q, k, v, o, lse, bh, s, d, dtype,
                                            scale2, fast, st);
  if (poly == 3)
    return sum ? smtl::launch_lse<3, true>(q, k, v, o, lse, bh, s, d, dtype,
                                           scale2, fast, st)
               : smtl::launch_lse<3, false>(q, k, v, o, lse, bh, s, d, dtype,
                                            scale2, fast, st);
  if (poly == 4)
    return sum ? smtl::launch_lse<4, true>(q, k, v, o, lse, bh, s, d, dtype,
                                           scale2, fast, st)
               : smtl::launch_lse<4, false>(q, k, v, o, lse, bh, s, d, dtype,
                                            scale2, fast, st);
  return kBadVariant;
}
#endif
