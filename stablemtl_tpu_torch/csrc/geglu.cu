// K6: fused GEGLU projection for Hopper (sm_90a),
//   y = (x W_h^T + b_h) * gelu(x W_g^T + b_g),
// x [R, C] row-major, W [2F, C] row-major (value rows 0..F-1, then the gate
// rows F..2F-1: the port's nn.Linear layout of the [C, 2F] Flax kernel),
// b [2F], y [R, F].
//
// Replaces stablemtl_tpu/ops/geglu.py::_geglu_kernel. Like it, both halves
// of the projection accumulate in f32 and the epilogue (bias, erf or tanh
// gelu, gate product) runs in f32 on the accumulators, so the [R, 2F]
// projection never reaches device memory: y is written once, in the input
// dtype. The biases are read in the input dtype (the module rounds them to
// it, as the JAX package's promote_dtype does) and widened in the epilogue.
//
// What bounds it on the H100. 4*R*C*F FLOPs against (R*C + 2*F*C + R*F)
// elements moved: at the SD2 stage-0 shape (R, C, F) = (28672, 320, 1280)
// about 47 GFLOP against 93 MB, i.e. ~500 FLOPs a byte, above the card's
// ~295 FLOPs/byte ridge, so the tensor cores bound it.
//
// Design (bf16). One CTA of 8 warps per [128 rows x 64 features] output
// tile, computing BOTH halves for its features (value rows f0.. and gate
// rows F+f0.. of W), so the gate product needs no exchange between CTAs.
// The warps sit 4 x 2, each owning 32 rows x 32 features of both halves:
// 2 x 4 m16n8k16 tiles per half, 64 f32 accumulators a thread. C streams
// through a 3-stage ring of shared-memory tiles (x, W_h, W_g; 32 wide, 8
// elements of row padding so ldmatrix reads no bank twice) filled by
// cp.async, so the loads of chunk k+2 overlap the products of chunk k;
// fragments come in by ldmatrix and the products run on mma.sync with f32
// accumulation. Rows past R are zero-filled on load (cp.async with a zero
// source size) and skipped on store, so R need not be a multiple of 128;
// C must be a multiple of 32 and F of 64 (ops/geglu.py gates on that). The
// grid's fast axis walks the feature tiles, so neighbouring CTAs share
// their x rows in L2. No TMA or wgmma yet.
//
// float32 instances (for checking only: mma.sync has no f32 form) run a
// simpler kernel of 4 warps on [64 x 64] tiles with scalar FMAs in the same
// fragment ownership and synchronous loads.

#include "flash_common.cuh"

namespace {

constexpr int GEGLU_BN = 64;  // features per CTA tile (per half)
constexpr int GEGLU_BK = 32;  // C chunk
constexpr int GEGLU_LDS = GEGLU_BK + PAD;
constexpr int MT = 2;  // m16 tiles per warp (32 rows)
constexpr int NT = 4;  // n8 tiles per warp and half (32 features)

// bf16 kernel
constexpr int BF_BM = 128;
constexpr int BF_WARPS = 8;
constexpr int BF_THREADS = BF_WARPS * 32;
constexpr int BF_STAGES = 3;
constexpr int BF_STAGE_ELEMS = (BF_BM + 2 * GEGLU_BN) * GEGLU_LDS;
constexpr size_t BF_SMEM =
    size_t(BF_STAGES) * BF_STAGE_ELEMS * sizeof(__nv_bfloat16);

// f32 checking kernel
constexpr int F32_BM = 64;

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_tanh(float g) {
  const float u = 0.7978845608028654f * (g + 0.044715f * g * g * g);
  return 0.5f * g * (1.f + tanhf(u));
}

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __bfloat162float(v);
  }
}

// Bias, gelu and gate product on a warp's [32 x 32] accumulator tiles of
// both halves, written once to y; rows at or past R are skipped.
template <typename T, bool TANH>
__device__ __forceinline__ void geglu_epilogue(
    const float (&acc_h)[MT][NT][4], const float (&acc_g)[MT][NT][4],
    const T* __restrict__ b, T* __restrict__ y, int row_base, int f_base,
    int R, int F) {
  const int lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int f = f_base + nt * 8 + tig * 2;
    const float bh0 = to_f32(b[f]), bh1 = to_f32(b[f + 1]);
    const float bg0 = to_f32(b[F + f]), bg1 = to_f32(b[F + f + 1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_base + mt * 16 + g + r * 8;
        if (row >= R) continue;
        const float g0 = acc_g[mt][nt][2 * r] + bg0;
        const float g1 = acc_g[mt][nt][2 * r + 1] + bg1;
        const float y0 = (acc_h[mt][nt][2 * r] + bh0) *
                         (TANH ? gelu_tanh(g0) : gelu_erf(g0));
        const float y1 = (acc_h[mt][nt][2 * r + 1] + bh1) *
                         (TANH ? gelu_tanh(g1) : gelu_erf(g1));
        T* out = y + int64_t(row) * F + f;
        if constexpr (std::is_same<T, float>::value) {
          *reinterpret_cast<float2*>(out) = make_float2(y0, y1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(out) =
              __floats2bfloat162_rn(y0, y1);
        }
      }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte cp.async; src_bytes 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

template <bool TANH>
__global__ void __launch_bounds__(BF_THREADS)
geglu_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w,
                  const __nv_bfloat16* __restrict__ b,
                  __nv_bfloat16* __restrict__ y, int R, int C, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int f0 = blockIdx.x * GEGLU_BN;
  const int row0 = blockIdx.y * BF_BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int KT = C / GEGLU_BK;

  // Stage s holds x rows [0, 128), then W_h rows, then W_g rows.
  auto load_stage = [&](int stage, int kt) {
    __nv_bfloat16* base = smem + stage * BF_STAGE_ELEMS;
    const int k0 = kt * GEGLU_BK;
    constexpr int CHUNKS = GEGLU_BK / 8;  // 16-byte chunks a row
    constexpr int ROWS = BF_BM + 2 * GEGLU_BN;
    for (int i = threadIdx.x; i < ROWS * CHUNKS; i += BF_THREADS) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
      const __nv_bfloat16* src;
      int bytes = 16;
      if (r < BF_BM) {
        const int row = row0 + r;
        bytes = row < R ? 16 : 0;
        src = x + int64_t(row < R ? row : 0) * C + k0 + c;
      } else if (r < BF_BM + GEGLU_BN) {
        src = w + int64_t(f0 + r - BF_BM) * C + k0 + c;
      } else {
        src = w + int64_t(F + f0 + r - BF_BM - GEGLU_BN) * C + k0 + c;
      }
      cp_async16(base + r * GEGLU_LDS + c, src, bytes);
    }
  };

  float acc_h[MT][NT][4], acc_g[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_h[mt][nt][e] = acc_g[mt][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < BF_STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }

  // ldmatrix lane addresses: A (16 x 16) as four 8 x 8 matrices (rows
  // 0-7 / 8-15, k 0-7 / 8-15); B two n8 tiles (n 0-7 / 8-15, k 0-7 /
  // 8-15) in the order b0, b1 of tile 0, then of tile 1
  const int a_row = lane % 16, a_col = (lane / 16) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<BF_STAGES - 2>();
    __syncthreads();
    // refill the stage the previous iteration read: every warp is past it
    const int next = kt + BF_STAGES - 1;
    if (next < KT) load_stage(next % BF_STAGES, next);
    cp_async_commit();

    const __nv_bfloat16* sx = smem + (kt % BF_STAGES) * BF_STAGE_ELEMS;
    const __nv_bfloat16* swh = sx + BF_BM * GEGLU_LDS;
    const __nv_bfloat16* swg = swh + GEGLU_BN * GEGLU_LDS;
#pragma unroll
    for (int ks = 0; ks < GEGLU_BK / 16; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], sx + (wm + mt * 16 + a_row) * GEGLU_LDS +
                               ks * 16 + a_col);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bh[4], bg[4];
        const int off = (wn + np * 16 + b_row) * GEGLU_LDS + ks * 16 + b_col;
        ldmatrix_x4(bh, swh + off);
        ldmatrix_x4(bg, swg + off);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mma16816(acc_h[mt][2 * np + j], a[mt][0], a[mt][1], a[mt][2],
                     a[mt][3], bh[2 * j], bh[2 * j + 1]);
            mma16816(acc_g[mt][2 * np + j], a[mt][0], a[mt][1], a[mt][2],
                     a[mt][3], bg[2 * j], bg[2 * j + 1]);
          }
      }
    }
  }
  cp_async_wait<0>();

  geglu_epilogue<__nv_bfloat16, TANH>(acc_h, acc_g, b, y, row0 + wm,
                                      f0 + wn, R, F);
}

template <bool TANH>
__global__ void __launch_bounds__(NTHREADS)
geglu_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, float* __restrict__ y, int R,
                 int C, int F) {
  __shared__ __align__(16) float sX[F32_BM * GEGLU_LDS];
  __shared__ __align__(16) float sWh[GEGLU_BN * GEGLU_LDS];
  __shared__ __align__(16) float sWg[GEGLU_BN * GEGLU_LDS];

  const int f0 = blockIdx.x * GEGLU_BN;
  const int row0 = blockIdx.y * F32_BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int valid = min(F32_BM, R - row0);

  float acc_h[MT][NT][4], acc_g[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_h[mt][nt][e] = acc_g[mt][nt][e] = 0.f;

  const float* xs = x + int64_t(row0) * C;
  const float* whs = w + int64_t(f0) * C;
  const float* wgs = w + int64_t(F + f0) * C;
  for (int k0 = 0; k0 < C; k0 += GEGLU_BK) {
    load_rows<float, GEGLU_BK, GEGLU_LDS>(sX, xs + k0, C, F32_BM, valid);
    load_rows<float, GEGLU_BK, GEGLU_LDS>(sWh, whs + k0, C, GEGLU_BN,
                                          GEGLU_BN);
    load_rows<float, GEGLU_BK, GEGLU_LDS>(sWg, wgs + k0, C, GEGLU_BN,
                                          GEGLU_BN);
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* xr = sX + (wm + mt * 16 + g + (e >> 1) * 8) * GEGLU_LDS;
          const int col = (wn + nt * 8 + tig * 2 + (e & 1)) * GEGLU_LDS;
          float h = acc_h[mt][nt][e], gg = acc_g[mt][nt][e];
          for (int j = 0; j < GEGLU_BK; ++j) {
            h = fmaf(xr[j], sWh[col + j], h);
            gg = fmaf(xr[j], sWg[col + j], gg);
          }
          acc_h[mt][nt][e] = h;
          acc_g[mt][nt][e] = gg;
        }
    __syncthreads();
  }
  geglu_epilogue<float, TANH>(acc_h, acc_g, b, y, row0 + wm, f0 + wn, R, F);
}

template <bool TANH>
int launch_bf16(const void* x, const void* w, const void* b, void* y, int R,
                int C, int F, cudaStream_t st) {
  auto kernel = geglu_bf16_kernel<TANH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(BF_SMEM));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(F / GEGLU_BN, (R + BF_BM - 1) / BF_BM);
  kernel<<<grid, BF_THREADS, BF_SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(y),
      R, C, F);
  return int(cudaGetLastError());
}

template <bool TANH>
int launch_f32(const void* x, const void* w, const void* b, void* y, int R,
               int C, int F, cudaStream_t st) {
  const dim3 grid(F / GEGLU_BN, (R + F32_BM - 1) / F32_BM);
  geglu_f32_kernel<TANH><<<grid, NTHREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(y), R, C, F);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int smtl_geglu(const void* x, const void* w, const void* b,
                          void* y, int rows, int c, int f, int dtype,
                          int tanh_gelu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || c % GEGLU_BK != 0 || f % GEGLU_BN != 0)
    return int(cudaErrorInvalidValue);
  if (dtype == 1)
    return tanh_gelu ? launch_bf16<true>(x, w, b, y, rows, c, f, st)
                     : launch_bf16<false>(x, w, b, y, rows, c, f, st);
  if (dtype == 0)
    return tanh_gelu ? launch_f32<true>(x, w, b, y, rows, c, f, st)
                     : launch_f32<false>(x, w, b, y, rows, c, f, st);
  return int(cudaErrorInvalidValue);
}
