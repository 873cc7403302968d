// Kernel B: flash-attention forward with the output's d split across CTAs,
// for the VAE's single-head mid-block attention (d = 512 at SD2 width).
// Replaces stablemtl_tpu/ops/flash_attention.py::_fa_stream_kernel; the
// kernel, what bounds it and its design are in flash_fwd.cuh.

#include "flash_fwd.cuh"

// d in {256, 512}, the VAE mid blocks of the small and full presets. bf16:
// 128-column d_v chunks, 64-key tiles. f32 tiles take twice the bytes:
// 64-column chunks, 32-key tiles.
extern "C" int smtl_flash_fwd_b(const void* q, const void* k, const void* v,
                                void* o, int bh, int s, int d, int dtype,
                                int fast, float scale2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 256)
    return launch_mode<__nv_bfloat16, 256, 128, 64>(q, k, v, o, bh, s,
                                                    scale2, fast, st);
  if (dtype == 1 && d == 512)
    return launch_mode<__nv_bfloat16, 512, 128, 64>(q, k, v, o, bh, s,
                                                    scale2, fast, st);
  if (dtype == 0 && d == 256)
    return launch_mode<float, 256, 64, 32>(q, k, v, o, bh, s, scale2, fast,
                                           st);
  if (dtype == 0 && d == 512)
    return launch_mode<float, 512, 64, 32>(q, k, v, o, bh, s, scale2, fast,
                                           st);
  return kBadArgument;
}
