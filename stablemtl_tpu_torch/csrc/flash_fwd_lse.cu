// K3: kernel A that also writes each row's base-2 logsumexp, the forward of
// the training path (UNet self-attention under autograd, head dim 64 at SD2
// width). Replaces stablemtl_tpu/ops/flash_attention.py::_fa_kernel with its
// lse output (reached through _flash_fwd); the kernel, what bounds it and
// its design are in flash_fwd.cuh. The backward kernels read the logsumexp
// as [bh, s] f32 (the TPU kernel stores it lane-replicated, a TPU tiling
// artifact).

#include "flash_fwd.cuh"

// d in {16, 32, 64}, as kernel A: one d_v chunk, 64-key tiles.
template <typename T>
int launch_lse(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int s, int d, float scale2, int fast,
               cudaStream_t st) {
  if (d == 16)
    return launch_mode<T, 16, 16, 64, true>(q, k, v, o, bh, s, scale2, fast,
                                            st, lse);
  if (d == 32)
    return launch_mode<T, 32, 32, 64, true>(q, k, v, o, bh, s, scale2, fast,
                                            st, lse);
  if (d == 64)
    return launch_mode<T, 64, 64, 64, true>(q, k, v, o, bh, s, scale2, fast,
                                            st, lse);
  return kBadArgument;
}

extern "C" int smtl_flash_fwd_lse(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int bh, int s, int d,
                                  int dtype, int fast, float scale2,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_lse<__nv_bfloat16>(q, k, v, o, lse, bh, s, d, scale2, fast,
                                     st);
  if (dtype == 0)
    return launch_lse<float>(q, k, v, o, lse, bh, s, d, scale2, fast, st);
  return kBadArgument;
}
