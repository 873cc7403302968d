// Building blocks of the float32 checking kernels of flash attention (the
// forward, flash_fwd.cuh; the backward's f32 instances in flash_bwd_dq.cu
// and flash_bwd_dkv.cu; the bf16 instances of all of them are Hopper
// kernels on TMA and wgmma, sm90.cuh); also the constants, the forward
// kernels' exp2 (exact, or the polynomial of STABLEMTL_FLASH_POLY_EXP), the
// launch helper and error strings every kernel source uses.
//
// The f32 kernels run 4 warps per CTA, each owning 16 rows of a 64-row
// tile, and keep their tile products in registers in the mma.sync m16n8k16
// fragment layout (though mma.sync has no f32 form and TF32 would not keep
// f32 accuracy, so every product is scalar f32 FMAs): thread (g = lane / 4,
// tig = lane % 4) holds, for n-tile nt, the elements (row g, cols nt*8 +
// tig*2 + {0, 1}) in c[nt][0..1] and (row g + 8, the same cols) in
// c[nt][2..3]. Two warp-level products cover all of them:
//   warp_gemm_nt  c += A . B^T, A and B both row-major in shared memory;
//   warp_gemm_pv  c += P . B, P in registers, B stored transposed ([n][k]),
//                 P going through a per-warp shared-memory tile.
// They exist for checking, not for speed.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;  // rows per CTA tile
constexpr int NWARPS = 4;    // 16 rows each
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 8;       // row padding (elements) against bank conflicts
constexpr float FAST_CLAMP = 110.f;
constexpr float NEG_BIG = -1e30f;

// Keys per tile of each forward kernel's online softmax. Under a variant
// and the exact softmax the result depends on them (the polynomial's
// rescale is not exact, and lsum's row sum rounds p against each tile's
// running max), so ops/flash_attention.py reads these four lines into
// KEY_TILE and the plain versions run the same tiles.
constexpr int A_BN = 128;          // kernel A and K3, bf16
constexpr int B_BN = 64;           // kernel B, bf16, 16 per consumer group
constexpr int RESIDENT_F32_BN = 64;  // kernel A and K3, f32
constexpr int STREAM_F32_BN = 32;    // kernel B, f32

// Returned by an entry point for a (d, dtype) it has no instance of, when
// cuTensorMapEncodeTiled refuses a TMA tensor map (sm90.cuh), and for a
// variant (poly, lsum) it has no instance of.
constexpr int kBadArgument = -1;
constexpr int kTmaEncodeFailed = -2;
constexpr int kBadVariant = -3;

// 2^x as the JAX package's _exp2_fast (stablemtl_tpu/ops/
// flash_attention.py): x clamped at -126, 2^floor(x) built in the exponent
// bits, times a degree-POLY polynomial in f = x - floor(x) (Horner's rule;
// the JAX package's coefficients). Relative error <= 7.7e-5 (POLY 3) or
// 2.7e-6 (4). Taken literally, floor and the int conversion would run at
// the 16 a clock an SM of conversions on this card, the rate of the exp2
// they replace; instead one add in round-down mode of 1.5 * 2^23 gives t
// with t - 1.5 * 2^23 = floor(x) exactly for x in [-126, 110] (t's unit is
// 1) and n = floor(x) in t's low mantissa bits, so ((bits(t) + 127) << 23)
// is 2^n's bit pattern: FP32 adds and FMAs (128 a clock) and two integer
// operations, no conversion.
template <int POLY>
__device__ __forceinline__ float exp2_poly(float x) {
  static_assert(POLY == 3 || POLY == 4, "polynomial degree");
  x = fmaxf(x, -126.f);
  const float t = __fadd_rd(x, 12582912.f);  // 1.5 * 2^23 + floor(x)
  const float f = x - (t - 12582912.f);
  float p;
  if constexpr (POLY == 3) {
    p = fmaf(fmaf(fmaf(0.07801587f, f, 0.22605866f), f, 0.69584812f), f,
             0.99992266f);
  } else {
    p = fmaf(fmaf(fmaf(fmaf(0.01353328f, f, 0.05201061f), f, 0.24144534f),
                  f, 0.69300269f),
             f, 1.00000269f);
  }
  return p * __uint_as_float((__float_as_uint(t) + 127u) << 23);
}

// The forward kernels' exp2: the special-function unit's (POLY 0) or the
// polynomial.
template <int POLY>
__device__ __forceinline__ float fwd_exp2(float x) {
  if constexpr (POLY == 0) {
    return exp2f(x);
  } else {
    return exp2_poly<POLY>(x);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy a [rows x COLS] tile (row stride ld in global, LDS in shared) with
// 16-byte vectors; rows at or past `valid` are zero-filled.
template <typename T, int COLS, int LDS>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int64_t ld,
                                          int rows, int valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = COLS / VEC;
  for (int i = threadIdx.x; i < rows * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * ld + c);
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = val;
  }
}

// Copy a [rows x COLS] tile transposed into dst[COLS][LDT]; rows past
// `valid` are zero.
template <typename T, int COLS, int LDT>
__device__ __forceinline__ void load_transposed(T* dst, const T* src,
                                                int64_t ld, int rows,
                                                int valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = COLS / VEC;
  for (int i = threadIdx.x; i < rows * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * ld + c);
    const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[(c + j) * LDT + r] = e[j];
  }
}

// c[nt] += A[16 x K] . B[NT*8 x K]^T for one warp: `a` points at the warp's
// first row of a row-major [.][LDA] tile, `b` at a row-major [NT*8][LDB]
// tile, both in shared memory.
template <int K, int NT, int LDA, int LDB>
__device__ __forceinline__ void warp_gemm_nt(float (&c)[NT][4],
                                             const float* a,
                                             const float* b) {
  const int lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* ar = a + (g + (e >> 1) * 8) * LDA;
      const float* br = b + (nt * 8 + tig * 2 + (e & 1)) * LDB;
      float acc = c[nt][e];
      for (int j = 0; j < K; ++j) acc = fmaf(ar[j], br[j], acc);
      c[nt][e] = acc;
    }
}

// c[nt] += P[16 x K] . B[K x NT*8] for one warp: P in registers in the
// fragment layout above (K/8 n-tiles), written to the warp's [16][SP] tile
// `pw`; B stored transposed as a row-major [NT*8][LDB] tile in shared
// memory.
template <int K, int NT, int LDB, int SP>
__device__ __forceinline__ void warp_gemm_pv(float (&c)[NT][4],
                                             const float (&p)[K / 8][4],
                                             const float* bt, float* pw) {
  const int lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < K / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pw[(g + (e >> 1) * 8) * SP + nt * 8 + tig * 2 + (e & 1)] = p[nt][e];
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* pr = pw + (g + (e >> 1) * 8) * SP;
      const float* br = bt + (nt * 8 + tig * 2 + (e & 1)) * LDB;
      float acc = c[nt][e];
      for (int j = 0; j < K; ++j) acc = fmaf(pr[j], br[j], acc);
      c[nt][e] = acc;
    }
  __syncwarp();
}

// Store a warp's [16 x NT*8] fragment tile, times `scale`, to rows
// row0 + {g, g + 8} of a row-major [S][D] f32 output; rows at or past S are
// skipped.
template <int NT, int D>
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&c)[NT][4], int row0,
                                           int S, float scale) {
  const int lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + r * 8;
    if (row >= S) continue;
    float* orow = out + int64_t(row) * D;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<float2*>(orow + nt * 8 + tig * 2) =
          make_float2(c[nt][2 * r] * scale, c[nt][2 * r + 1] * scale);
  }
}

// Launch `kernel` with `threads` threads and `smem` bytes of dynamic shared
// memory (opting in above the 48 KB default); returns the launch's
// cudaError_t.
template <typename Kernel, typename... Args>
int launch_kernel(Kernel kernel, dim3 grid, int threads, size_t smem,
                  cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return int(cudaGetLastError());
}

}  // namespace

// Once a library: not in a variant's part (SMTL_POLY, ops/cuda_build.py).
#ifndef SMTL_POLY
extern "C" const char* smtl_cuda_error_string(int err) {
  if (err == kBadArgument) return "unsupported head dim or dtype";
  if (err == kTmaEncodeFailed) return "cuTensorMapEncodeTiled failed";
  if (err == kBadVariant) return "no instance of this variant (poly, lsum)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#endif
