// Kernel A (K1): flash-attention forward for the UNet's self-attention at
// inference, no logsumexp. Replaces
// stablemtl_tpu/ops/flash_attention.py::_fa_kernel_nolse (body _fa_kernel).
//
// bf16 runs the Hopper template of flash_fwd_a_sm90.cuh with two consumer
// warpgroups (128-row CTAs), where its design and what bounds it on the
// H100 are written down; the same template with LSE on is K3
// (flash_fwd_lse.cu). float32 inputs run the first-version template of
// flash_fwd.cuh: wgmma has no f32 form and TF32 would break the f32
// checks; the f32 path exists for checks.
//
// The JAX package's variants (STABLEMTL_FLASH_POLY_EXP: poly 3 or 4;
// STABLEMTL_FLASH_MXU_LSUM: lsum) are instances of their own, described in
// flash_fwd_a_sm90.cuh. Compiled whole, this source took up to 121 s of
// nvcc on the H100 machine (PERF.md), so ops/cuda_build.py compiles each
// variant's instances in a part of its own, in parallel (SMTL_POLY and
// SMTL_LSUM defined), and links the parts into one library.

#include "flash_fwd.cuh"
#include "flash_fwd_a_sm90.cuh"

namespace smtl {

// The instances of one variant: d in {16, 32, 64}, the head dims of the
// presets' UNets and of the tiny VAE's mid block. f32: one d_v chunk,
// 64-key tiles, no LSUM instance (the caller passes lsum 0).
template <int POLY, bool LSUM>
int launch_a(const void* q, const void* k, const void* v, void* o, int bh,
             int s, int d, int dtype, float scale2, int fast,
             cudaStream_t st) {
  if (dtype == 1) {
    if (d == 16)
      return launch_a_sm90<16, 2, false, POLY, LSUM>(q, k, v, o, nullptr, bh,
                                                     s, scale2, fast, st);
    if (d == 32)
      return launch_a_sm90<32, 2, false, POLY, LSUM>(q, k, v, o, nullptr, bh,
                                                     s, scale2, fast, st);
    if (d == 64)
      return launch_a_sm90<64, 2, false, POLY, LSUM>(q, k, v, o, nullptr, bh,
                                                     s, scale2, fast, st);
  } else if constexpr (!LSUM) {
    if (dtype == 0 && d == 16)
      return launch_mode<16, 16, RESIDENT_F32_BN, false, POLY>(
          q, k, v, o, bh, s, scale2, fast, st);
    if (dtype == 0 && d == 32)
      return launch_mode<32, 32, RESIDENT_F32_BN, false, POLY>(
          q, k, v, o, bh, s, scale2, fast, st);
    if (dtype == 0 && d == 64)
      return launch_mode<64, 64, RESIDENT_F32_BN, false, POLY>(
          q, k, v, o, bh, s, scale2, fast, st);
  }
  return kBadArgument;
}

}  // namespace smtl

#define SMTL_LAUNCH_A_ARGS                                                  \
  const void*, const void*, const void*, void*, int, int, int, int, float, \
      int, cudaStream_t

// A variant's part (SMTL_POLY and SMTL_LSUM defined, ops/cuda_build.py's
// PARTS) instantiates that variant; the source without defines holds the
// entry point and the default's instances.
#ifdef SMTL_POLY
template int smtl::launch_a<SMTL_POLY, (SMTL_LSUM != 0)>(
    SMTL_LAUNCH_A_ARGS);
#else
extern template int smtl::launch_a<0, true>(SMTL_LAUNCH_A_ARGS);
extern template int smtl::launch_a<3, false>(SMTL_LAUNCH_A_ARGS);
extern template int smtl::launch_a<3, true>(SMTL_LAUNCH_A_ARGS);
extern template int smtl::launch_a<4, false>(SMTL_LAUNCH_A_ARGS);
extern template int smtl::launch_a<4, true>(SMTL_LAUNCH_A_ARGS);

// poly in {0, 3, 4}, lsum in {0, 1} (dropped for f32); any other variant
// returns kBadVariant.
extern "C" int smtl_flash_fwd_a(const void* q, const void* k, const void* v,
                                void* o, int bh, int s, int d, int dtype,
                                int fast, int poly, int lsum, float scale2,
                                void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const bool sum = lsum != 0 && dtype != 0;
  if (poly == 0)
    return sum ? smtl::launch_a<0, true>(q, k, v, o, bh, s, d, dtype, scale2,
                                         fast, st)
               : smtl::launch_a<0, false>(q, k, v, o, bh, s, d, dtype,
                                          scale2, fast, st);
  if (poly == 3)
    return sum ? smtl::launch_a<3, true>(q, k, v, o, bh, s, d, dtype, scale2,
                                         fast, st)
               : smtl::launch_a<3, false>(q, k, v, o, bh, s, d, dtype,
                                          scale2, fast, st);
  if (poly == 4)
    return sum ? smtl::launch_a<4, true>(q, k, v, o, bh, s, d, dtype, scale2,
                                         fast, st)
               : smtl::launch_a<4, false>(q, k, v, o, bh, s, d, dtype,
                                          scale2, fast, st);
  return kBadVariant;
}
#endif
