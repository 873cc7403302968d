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

#include "flash_fwd.cuh"
#include "flash_fwd_a_sm90.cuh"

namespace {

// d in {16, 32, 64}, the head dims of the presets' UNets and of the tiny
// VAE's mid block. f32: one d_v chunk, 64-key tiles.
int launch_a(const void* q, const void* k, const void* v, void* o, int bh,
             int s, int d, int dtype, float scale2, int fast,
             cudaStream_t st) {
  if (dtype == 1) {
    if (d == 16)
      return launch_a_sm90<16, 2, false>(q, k, v, o, nullptr, bh, s, scale2,
                                         fast, st);
    if (d == 32)
      return launch_a_sm90<32, 2, false>(q, k, v, o, nullptr, bh, s, scale2,
                                         fast, st);
    if (d == 64)
      return launch_a_sm90<64, 2, false>(q, k, v, o, nullptr, bh, s, scale2,
                                         fast, st);
  } else if (dtype == 0) {
    if (d == 16)
      return launch_mode<16, 16, 64>(q, k, v, o, bh, s, scale2, fast, st);
    if (d == 32)
      return launch_mode<32, 32, 64>(q, k, v, o, bh, s, scale2, fast, st);
    if (d == 64)
      return launch_mode<64, 64, 64>(q, k, v, o, bh, s, scale2, fast, st);
  }
  return kBadArgument;
}

}  // namespace

extern "C" int smtl_flash_fwd_a(const void* q, const void* k, const void* v,
                                void* o, int bh, int s, int d, int dtype,
                                int fast, float scale2, void* stream) {
  return launch_a(q, k, v, o, bh, s, d, dtype, scale2, fast,
                  static_cast<cudaStream_t>(stream));
}
