// Building blocks shared by the first-version flash-attention kernels for
// Hopper (sm_90a): the float32 forward (flash_fwd.cuh) and the two backward
// kernels (flash_bwd_dq.cu, flash_bwd_dkv.cu); also the constants, launch
// helper and error strings every kernel source uses.
//
// Every kernel runs 4 warps per CTA, each owning 16 rows of a 64-row tile,
// and keeps its tile products in registers in the mma.sync m16n8k16 fragment
// layout: thread (g = lane / 4, tig = lane % 4) holds, for n-tile nt, the
// elements (row g, cols nt*8 + tig*2 + {0, 1}) in c[nt][0..1] and
// (row g + 8, the same cols) in c[nt][2..3]. Two warp-level products cover
// all of them:
//   warp_gemm_nt  c += A . B^T, A and B both row-major in shared memory;
//   warp_gemm_pv  c += P . B, P in registers (rounded to the input dtype, as
//                 the TPU kernels round it), B stored transposed ([n][k]).
// float32 inputs: mma.sync has no f32 form and TF32 would not keep f32
// accuracy, so both products run as scalar f32 FMAs in the same fragment
// ownership (P goes through a per-warp shared-memory tile). The f32 path
// exists for checking, not for speed.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BLOCK_M = 64;  // rows per CTA tile
constexpr int NWARPS = 4;    // 16 rows each
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 8;       // row padding (elements) against bank conflicts
constexpr float FAST_CLAMP = 110.f;
constexpr float NEG_BIG = -1e30f;

// Returned by an entry point for a (d, dtype) it has no instance of, and
// when cuTensorMapEncodeTiled refuses a TMA tensor map (sm90.cuh).
constexpr int kBadArgument = -1;
constexpr int kTmaEncodeFailed = -2;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
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
template <typename T, int K, int NT, int LDA, int LDB>
__device__ __forceinline__ void warp_gemm_nt(float (&c)[NT][4], const T* a,
                                             const T* b) {
  const int lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;
  if constexpr (!std::is_same<T, float>::value) {
#pragma unroll 4
    for (int ks = 0; ks < K / 16; ++ks) {
      const T* pa = a + g * LDA + ks * 16 + tig * 2;
      const uint32_t a0 = ld32(pa), a1 = ld32(pa + 8 * LDA);
      const uint32_t a2 = ld32(pa + 8), a3 = ld32(pa + 8 * LDA + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const T* pb = b + (nt * 8 + g) * LDB + ks * 16 + tig * 2;
        mma16816(c[nt], a0, a1, a2, a3, ld32(pb), ld32(pb + 8));
      }
    }
  } else {
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
}

// c[nt] += P[16 x K] . B[K x NT*8] for one warp: P in registers in the
// fragment layout above (K/8 n-tiles), B stored transposed as a row-major
// [NT*8][LDB] tile in shared memory. bf16: P is rounded to bf16 and fed as
// the A fragment straight from registers. f32: P goes through the warp's
// [16][SP] tile `pw`.
template <typename T, int K, int NT, int LDB, int SP>
__device__ __forceinline__ void warp_gemm_pv(float (&c)[NT][4],
                                             const float (&p)[K / 8][4],
                                             const T* bt, float* pw) {
  const int lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;
  if constexpr (!std::is_same<T, float>::value) {
#pragma unroll
    for (int kc = 0; kc < K / 16; ++kc) {
      const uint32_t a0 = pack_bf16(p[2 * kc][0], p[2 * kc][1]);
      const uint32_t a1 = pack_bf16(p[2 * kc][2], p[2 * kc][3]);
      const uint32_t a2 = pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]);
      const uint32_t a3 = pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const T* pb = bt + (nt * 8 + g) * LDB + kc * 16 + tig * 2;
        mma16816(c[nt], a0, a1, a2, a3, ld32(pb), ld32(pb + 8));
      }
    }
  } else {
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
}

// Store a warp's [16 x NT*8] fragment tile, times `scale`, to rows
// row0 + {g, g + 8} of a row-major [S][D] output; rows at or past S are
// skipped.
template <typename T, int NT, int D>
__device__ __forceinline__ void store_rows(T* out, const float (&c)[NT][4],
                                           int row0, int S, float scale) {
  const int lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + r * 8;
    if (row >= S) continue;
    T* orow = out + int64_t(row) * D;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float x0 = c[nt][2 * r] * scale, x1 = c[nt][2 * r + 1] * scale;
      if constexpr (std::is_same<T, float>::value) {
        *reinterpret_cast<float2*>(orow + nt * 8 + tig * 2) =
            make_float2(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8 + tig * 2) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
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

extern "C" const char* smtl_cuda_error_string(int err) {
  if (err == kBadArgument) return "unsupported head dim or dtype";
  if (err == kTmaEncodeFailed) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
