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
// elements moved: at the batch-2 serving step's stage-0 shape (R, C, F) =
// (57344, 320, 1280) 94 GFLOP against 184 MB, ~500 FLOPs a byte, above the
// card's ~295 FLOPs/byte ridge, so the tensor cores bound it (0.095 ms).
// Two more costs sit beside the products: the epilogue's erf, ~16 k per
// 128 x 128 tile, about as long as the products at C = 320; and L2, which
// feeds every stage's x and W boxes to the SMs (W is re-read by every row
// tile, x by every feature tile).
//
// Design (bf16). A persistent kernel: one CTA per SM walks the output
// tiles of 128 rows x 128 features (features fast, so CTAs that share x
// rows run together and W stays in L2). Each CTA runs three warpgroups:
//   - a producer (warpgroup 2, one thread working) that loads, for each
//     tile and each 64-wide chunk of C, three TMA boxes with the 128-byte
//     swizzle into a ring of G_STAGES stages guarded by full and empty
//     mbarriers: x [128 rows x 64], W_h [128 features x 64] at row f0 and
//     W_g [128 x 64] at row F + f0. It runs ahead across tiles, so the
//     next tile's loads overlap this tile's epilogue; it gives registers
//     back with setmaxnreg.
//   - two consumers of 64 rows each. For every k16 step a consumer issues
//     two wgmma m64n128k16 from shared memory (both operands K-major), one
//     into the value accumulator and one into the gate accumulator (64 +
//     64 f32 registers a thread), keeping one stage's products in flight
//     (wgmma.wait_group 1) and releasing the stage before it. The two
//     accumulators share one fragment layout, so the epilogue is
//     elementwise in registers: bias, gelu, product, one rounding to bf16,
//     written with the 128-byte swizzle into a shared-memory tile that one
//     thread stores with TMA (two [64 x 64] boxes).
// The tensor cores idle while both consumers run the epilogue (at C = 320
// nearly half the kernel's time on the H100, PERF.md). Arrangements that
// overlap or feed it otherwise measured no faster and were not kept: 64-row
// tiles on ping-ponged consumers (one's epilogue under the other's
// products) read W twice as often and were slower at C >= 640; a 2-CTA
// cluster multicasting the W boxes gained little; starting consumer 1 a
// few stages behind consumer 0 changed nothing (the one left with the
// tensor cores catches up).
// Rows past R and C past its last multiple of 64 arrive as TMA zero fill
// (zero columns add nothing; this covers C = 32 and C = 160), and the TMA
// store writes no row past R and no feature past F, so R is free, C must
// be a multiple of 32 and F of 64 (ops/geglu.py gates on that).
//
// float32 instances (for checking only: wgmma has no f32 form) run a
// simpler kernel of 4 warps on [64 x 64] tiles with scalar FMAs in the
// mma.sync fragment ownership and synchronous loads.

#include "flash_common.cuh"
#include "sm90.cuh"

namespace {

// ---- shape gate and f32 checking kernel ------------------------------------
constexpr int GEGLU_BN = 64;  // features per f32 tile (per half); F % 64
constexpr int GEGLU_BK = 32;  // f32 C chunk; C % 32
constexpr int GEGLU_LDS = GEGLU_BK + PAD;
constexpr int MT = 2;  // m16 tiles per warp (32 rows)
constexpr int NT = 4;  // n8 tiles per warp and half (32 features)
constexpr int F32_BM = 64;

// ---- bf16 Hopper kernel -----------------------------------------------------
constexpr int G_BM = 128;       // rows per tile, 64 per consumer
constexpr int G_BN = 128;       // features per tile (per half)
constexpr int G_BK = 64;        // C per stage: one 128-byte swizzle span
constexpr int G_STAGES = 4;
constexpr int G_THREADS = 384;  // consumers 0, 1; producer 2
constexpr int G_SPAN = 128;     // bytes per box row
constexpr int G_SBO = 8 * G_SPAN / 16;  // 8-row groups, 16-byte units
constexpr int G_X_BYTES = G_BM * G_SPAN;      // the x box, 16 KB
constexpr int G_W_BYTES = G_BN * G_SPAN;      // one half's box, 16 KB
constexpr int G_STAGE_BYTES = G_X_BYTES + 2 * G_W_BYTES;  // 48 KB
constexpr int G_OUT_BYTES = 64 * G_BN * 2;    // a consumer's [64 x 128] y
constexpr int G_OUT_OFF = G_STAGES * G_STAGE_BYTES;
constexpr int G_BAR_OFF = G_OUT_OFF + 2 * G_OUT_BYTES;
// full[G_STAGES], empty[G_STAGES]; 1024 bytes of alignment slack
constexpr size_t G_SMEM = G_BAR_OFF + 2 * G_STAGES * 8 + 1024;
static_assert(G_SMEM <= 232448, "shared memory");

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_tanh(float g) {
  const float u = 0.7978845608028654f * (g + 0.044715f * g * g * g);
  return 0.5f * g * (1.f + tanhf(u));
}

template <bool TANH>
__global__ void __launch_bounds__(G_THREADS, 1)
geglu_sm90(const __grid_constant__ CUtensorMap map_x,
           const __grid_constant__ CUtensorMap map_w,
           const __grid_constant__ CUtensorMap map_y,
           const __nv_bfloat16* __restrict__ b, int R, int C, int F) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G_BAR_OFF);
  uint64_t* empty = full + G_STAGES;

  const int n_ft = (F + G_BN - 1) / G_BN;
  const int n_tiles = (R + G_BM - 1) / G_BM * n_ft;
  const int n_k = (C + G_BK - 1) / G_BK;
  // this CTA's tiles: blockIdx.x + i * gridDim.x for i < n_mine
  const int n_mine = (n_tiles - int(blockIdx.x) + int(gridDim.x) - 1) /
                     int(gridDim.x);
  if (threadIdx.x == 0) {
    for (int st = 0; st < G_STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer ---------------------------------------------------------
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int it = 0;  // stages filled so far, over all of this CTA's tiles
      for (int i = 0; i < n_mine; ++i) {
        const int tile = blockIdx.x + i * gridDim.x;
        const int row0 = (tile / n_ft) * G_BM, f0 = (tile % n_ft) * G_BN;
        for (int kc = 0; kc < n_k; ++kc, ++it) {
          const int st = it % G_STAGES;
          mbar_wait(&empty[st], ((it / G_STAGES) & 1) ^ 1);
          unsigned char* dst = smem + st * G_STAGE_BYTES;
          mbar_expect_tx(&full[st], G_STAGE_BYTES);
          tma_load_3d(dst, &map_x, &full[st], kc * G_BK, row0, 0);
          tma_load_3d(dst + G_X_BYTES, &map_w, &full[st], kc * G_BK, f0, 0);
          tma_load_3d(dst + G_X_BYTES + G_W_BYTES, &map_w, &full[st],
                      kc * G_BK, F + f0, 0);
        }
      }
    }
  } else {
    // ---- consumers --------------------------------------------------------
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    unsigned char* out = smem + G_OUT_OFF + wg * G_OUT_BYTES;
    float acc_h[G_BN / 2], acc_g[G_BN / 2];

    for (int i = 0; i < n_mine; ++i) {
      const int tile = blockIdx.x + i * gridDim.x;
      const int f0 = (tile % n_ft) * G_BN;
      const int row0 = (tile / n_ft) * G_BM + wg * 64;  // this consumer's

      // ---- main loop: both halves over C ---------------------------------
      int it = i * n_k;
      for (int kc = 0; kc < n_k; ++kc, ++it) {
        const int st = it % G_STAGES;
        mbar_wait(&full[st], (it / G_STAGES) & 1);
        const unsigned char* sx = smem + st * G_STAGE_BYTES;
        const uint64_t dx = smem_desc(sx + wg * 64 * G_SPAN, 1, G_SBO, 1);
        const uint64_t dh = smem_desc(sx + G_X_BYTES, 1, G_SBO, 1);
        const uint64_t dg = smem_desc(sx + G_X_BYTES + G_W_BYTES, 1, G_SBO,
                                      1);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < G_BK / 16; ++ks) {  // +32 bytes per k16 step
          const int accumulate = kc > 0 || ks > 0;
          wgmma_ss<G_BN, 0>(acc_h, dx + 2 * ks, dh + 2 * ks, accumulate);
          wgmma_ss<G_BN, 0>(acc_g, dx + 2 * ks, dg + 2 * ks, accumulate);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        if (kc > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % G_STAGES]);
      }
      wgmma_wait<0>();
      fence_regs(acc_h);
      fence_regs(acc_g);
      if (lane == 0) mbar_arrive(&empty[(it - 1) % G_STAGES]);

      // ---- epilogue: bias, gelu, product; y through shared memory --------
      if (tid == 0) bulk_wait_read();  // the last store has read `out`
      named_bar_sync(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < G_BN / 8; ++j) {
        const int f = f0 + 8 * j + 2 * t;
        float bh0 = 0.f, bh1 = 0.f, bg0 = 0.f, bg1 = 0.f;
        if (f < F) {  // F % 64 == 0: f and f + 1 both in range
          bh0 = __bfloat162float(b[f]);
          bh1 = __bfloat162float(b[f + 1]);
          bg0 = __bfloat162float(b[F + f]);
          bg1 = __bfloat162float(b[F + f + 1]);
        }
        // box j / 8 holds features 64 (j / 8).., chunk j % 8 of each row,
        // stored at chunk (j % 8) ^ (row % 8): the 128-byte swizzle
        unsigned char* box = out + (j / 8) * (64 * G_SPAN);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = warp * 16 + g + 8 * r;
          const float g0 = acc_g[4 * j + 2 * r] + bg0;
          const float g1 = acc_g[4 * j + 2 * r + 1] + bg1;
          const float y0 = (acc_h[4 * j + 2 * r] + bh0) *
                           (TANH ? gelu_tanh(g0) : gelu_erf(g0));
          const float y1 = (acc_h[4 * j + 2 * r + 1] + bh1) *
                           (TANH ? gelu_tanh(g1) : gelu_erf(g1));
          *reinterpret_cast<__nv_bfloat162*>(
              box + row * G_SPAN + (((j % 8) ^ (row % 8)) << 4) + 4 * t) =
              __floats2bfloat162_rn(y0, y1);
        }
      }
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);
      if (tid == 0) {
        if (row0 < R) {  // a tile's last 64 rows may lie wholly past R
          tma_store_3d(&map_y, out, f0, row0, 0);
          if (f0 + 64 < F)
            tma_store_3d(&map_y, out + 64 * G_SPAN, f0 + 64, row0, 0);
        }
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait();
  }
}

// Bias, gelu and gate product on a warp's [32 x 32] accumulator tiles of
// both halves, written once to y; rows at or past R are skipped.
template <bool TANH>
__device__ __forceinline__ void geglu_epilogue_f32(
    const float (&acc_h)[MT][NT][4], const float (&acc_g)[MT][NT][4],
    const float* __restrict__ b, float* __restrict__ y, int row_base,
    int f_base, int R, int F) {
  const int lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int f = f_base + nt * 8 + tig * 2;
    const float bh0 = b[f], bh1 = b[f + 1];
    const float bg0 = b[F + f], bg1 = b[F + f + 1];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_base + mt * 16 + g + r * 8;
        if (row >= R) continue;
        const float g0 = acc_g[mt][nt][2 * r] + bg0;
        const float g1 = acc_g[mt][nt][2 * r + 1] + bg1;
        *reinterpret_cast<float2*>(y + int64_t(row) * F + f) = make_float2(
            (acc_h[mt][nt][2 * r] + bh0) *
                (TANH ? gelu_tanh(g0) : gelu_erf(g0)),
            (acc_h[mt][nt][2 * r + 1] + bh1) *
                (TANH ? gelu_tanh(g1) : gelu_erf(g1)));
      }
  }
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
  geglu_epilogue_f32<TANH>(acc_h, acc_g, b, y, row0 + wm, f0 + wn, R, F);
}

template <bool TANH>
int launch_bf16(const void* x, const void* w, const void* b, void* y, int R,
                int C, int F, cudaStream_t st) {
  CUtensorMap mx, mw, my;
  if (make_tensor_map(&mx, x, 1, R, C, G_BK, G_BM) ||
      make_tensor_map(&mw, w, 1, 2 * F, C, G_BK, G_BN) ||
      make_tensor_map(&my, y, 1, R, F, 64, 64))
    return kTmaEncodeFailed;
  const int n_tiles = (R + G_BM - 1) / G_BM * ((F + G_BN - 1) / G_BN);
  const dim3 grid(n_tiles < sm_count() ? n_tiles : sm_count());
  return launch_kernel(geglu_sm90<TANH>, grid, G_THREADS, G_SMEM, st, mx, mw,
                       my, static_cast<const __nv_bfloat16*>(b), R, C, F);
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
