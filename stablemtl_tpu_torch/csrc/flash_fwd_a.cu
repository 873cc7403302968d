// Kernel A: flash-attention forward with the output accumulator in
// registers, for the UNet's self-attention (head dim 64 at SD2 width).
// Replaces stablemtl_tpu/ops/flash_attention.py::_fa_kernel_nolse; the
// kernel, what bounds it and its design are in flash_fwd.cuh.

#include "flash_fwd.cuh"

// d in {16, 32, 64}, the head dims of the presets' UNets and of the tiny
// VAE's mid block: one d_v chunk, 64-key tiles.
template <typename T>
int launch_a(const void* q, const void* k, const void* v, void* o, int bh,
             int s, int d, float scale2, int fast, cudaStream_t st) {
  if (d == 16)
    return launch_mode<T, 16, 16, 64>(q, k, v, o, bh, s, scale2, fast, st);
  if (d == 32)
    return launch_mode<T, 32, 32, 64>(q, k, v, o, bh, s, scale2, fast, st);
  if (d == 64)
    return launch_mode<T, 64, 64, 64>(q, k, v, o, bh, s, scale2, fast, st);
  return kBadArgument;
}

extern "C" int smtl_flash_fwd_a(const void* q, const void* k, const void* v,
                                void* o, int bh, int s, int d, int dtype,
                                int fast, float scale2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_a<__nv_bfloat16>(q, k, v, o, bh, s, d, scale2, fast, st);
  if (dtype == 0)
    return launch_a<float>(q, k, v, o, bh, s, d, scale2, fast, st);
  return kBadArgument;
}
