// Kernel B: flash-attention forward for the VAE's single-head mid-block
// attention (d = 512 at SD2 width, 256 for the small preset), bf16, on
// Hopper's TMA and wgmma. Replaces
// stablemtl_tpu/ops/flash_attention.py::_fa_stream_kernel (K/V streamed
// through VMEM): softmax(q k^T d^-1/2) v with the base-2 online softmax and,
// under FAST, the max-free p = exp2(clamp(s, +-110)); the arithmetic is
// kernel A's (flash_fwd_a_sm90.cuh).
//
// What bounds it on the H100. At [7, 4096, 512]: 4 * 4096^2 * 512 * 7 =
// 2.41e11 FLOPs / 989e12 FLOP/s = 0.243 ms of tensor-core work, against
// 4096^2 * 7 = 1.17e8 exp2 (0.028 ms) and 117 MB of q, k, v, o (0.035 ms):
// the products bound it, and every score computed twice is time lost.
//
// Design. A 64 x 512 f32 output accumulator fits no thread's registers, so
// the first version split the output's d across 4 CTAs, each recomputing
// the full-d scores: 2.5x the minimal tensor-core work, at one 4-warp CTA
// an SM. Here one CTA owns a 64-row q tile of one head and splits d across
// its 4 consumer warpgroups instead (64 x D/4 f32 accumulators, 64
// registers a thread at d = 512), so each score is computed once:
//   - a producer warpgroup (one thread working; it gives its registers to
//     the consumers with setmaxnreg, without which ptxas capped the
//     consumers at 96 registers and spilled) loads q once and then K and V
//     tiles of 64 keys by TMA, each as D/64 boxes of 64 columns (128-byte
//     swizzle);
//   - consumer w computes the scores of its own 16 keys of the tile over
//     the full d (wgmma m64n16k16, q and k K-major from shared memory);
//   - the row maxima are exchanged through shared memory (exact softmax
//     only), each group rescales its own accumulator slice by the shared
//     alpha, and writes its 64 x 16 slice of p in bf16 into a shared
//     64 x 64 tile in the swizzled layout wgmma reads;
//   - each group then adds p v over all 64 keys to its D/4 output columns
//     (wgmma m64n(D/4)k16, p K-major, the V tile MN-major as TMA wrote it:
//     no transposed copy);
//   - the row sums are added across the groups in a fixed order at the
//     end, so no result depends on scheduling.
// One buffer each for q (64 KB at d = 512), K (64 KB) and V (64 KB), plus
// two of p (16 KB): ~210 KB. The next K loads while the groups run the
// softmax and p v; the next V while they compute scores. 32-key tiles in
// two stages fit the same shared memory and measured slower on the H100
// (0.96 against 0.68 ms at [7, 4096, 512] in fast softmax, 1.24 against
// 0.75 exact; PERF.md), with twice the barrier rounds per key and n8
// score products. Why this way and not the others: splitting the score
// reduction over d instead needs four 64 x 64 f32 partial tiles (64 KB
// more, so 32-key tiles) and an ordered sum of them every tile; a 2-CTA
// cluster sharing scores over distributed shared memory halves neither the
// q nor the K traffic. Keys past S arrive as TMA zero fill and are masked;
// rows past S are not stored.
//
// float32 inputs stay on the first-version template (flash_fwd.cuh, d split
// across CTAs): wgmma has no f32 form and TF32 would break the f32 checks.
//
// STABLEMTL_FLASH_POLY_EXP (POLY 3, 4) is the JAX package's variant of this
// kernel: p and the rescale alpha from the polynomial of flash_common.cuh
// instead of exp2, a masked key's p set to 0. The products bound the
// kernel, not the 0.028 ms of exp2, so the polynomial's extra FP32 work
// mostly hides behind them: on the H100 within 0.5 % of the default in the
// fast softmax, 2-3 % slower in the exact one (PERF.md), at
// [7, 4096, 512]. STABLEMTL_FLASH_MXU_LSUM does not apply: the JAX
// package's streaming kernel ignores it. Built in parts as flash_fwd_a.cu
// (each degree's instances, SMTL_POLY).

#include "flash_fwd.cuh"
#include "sm90.cuh"

namespace {

constexpr int B_BM = 64;       // q rows per CTA
constexpr int B_KW = B_BN / 4;
constexpr int B_CONSUMERS = 512;
constexpr int B_THREADS = B_CONSUMERS + 128;  // + a producer warpgroup
constexpr int B_REGION = 64 * 128;           // one 64-row, 128-byte box

template <int D>
struct BCfg {
  static constexpr int NBOX = D / 64;  // 64-column boxes per row block
  static constexpr int DW = D / 4;     // output columns per group
  static constexpr int TILE = NBOX * B_REGION;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + TILE;
  static constexpr int V_OFF = K_OFF + TILE;
  static constexpr int P_OFF = V_OFF + TILE;        // 2 x [64][64] bf16
  static constexpr int MAX_OFF = P_OFF + 2 * B_REGION;  // 2 x [4][64] f32
  static constexpr int SUM_OFF = MAX_OFF + 2 * 4 * 64 * 4;  // [4][64] f32
  static constexpr int BAR_OFF = SUM_OFF + 4 * 64 * 4;
  static constexpr size_t SMEM = BAR_OFF + 5 * 8 + 1024;
  static_assert(D == 256 || D == 512, "head dim");
  static_assert(SMEM <= 232448, "shared memory");
};

template <int D, bool FAST, int POLY>
__global__ void __launch_bounds__(B_THREADS, 1)
flash_fwd_b_sm90(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 __nv_bfloat16* __restrict__ o, int S, float scale2) {
  using C = BCfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* sq = smem + C::Q_OFF;
  unsigned char* sk = smem + C::K_OFF;
  unsigned char* sv = smem + C::V_OFF;
  float* s_max = reinterpret_cast<float*>(smem + C::MAX_OFF);
  float* s_sum = reinterpret_cast<float*>(smem + C::SUM_OFF);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t *q_full = bars, *k_full = bars + 1, *k_empty = bars + 2;
  uint64_t *v_full = bars + 3, *v_empty = bars + 4;

  const int q0 = blockIdx.x * B_BM, bh = blockIdx.y;
  const int n_kt = (S + B_BN - 1) / B_BN;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    mbar_init(k_empty, 16);  // one arrival per consumer warp
    mbar_init(v_empty, 16);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= B_CONSUMERS) {
    // ---- producer -----------------------------------------------------------
    setmaxnreg_dec<32>();
    if (threadIdx.x == B_CONSUMERS) {
      mbar_expect_tx(q_full, C::TILE);
      for (int b = 0; b < C::NBOX; ++b)
        tma_load_3d(sq + b * B_REGION, &map_q, q_full, b * 64, q0, bh);
      for (int j = 0; j < n_kt; ++j) {
        const uint32_t parity = (j & 1) ^ 1;
        mbar_wait(k_empty, parity);
        mbar_expect_tx(k_full, C::TILE);
        for (int b = 0; b < C::NBOX; ++b)
          tma_load_3d(sk + b * B_REGION, &map_k, k_full, b * 64, j * B_BN,
                      bh);
        mbar_wait(v_empty, parity);
        mbar_expect_tx(v_full, C::TILE);
        for (int b = 0; b < C::NBOX; ++b)
          tma_load_3d(sv + b * B_REGION, &map_v, v_full, b * 64, j * B_BN,
                      bh);
      }
    }
    return;
  }

  // ---- consumers ------------------------------------------------------------
  setmaxnreg_inc<112>();
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  constexpr int NO = C::DW / 2;  // output registers: 64 x D/4 per group
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m[2] = {FAST ? 0.f : NEG_BIG, FAST ? 0.f : NEG_BIG};
  float l[2] = {0.f, 0.f};  // per-thread partial sums over this group's keys
  const int row0 = warp * 16 + g;  // this thread's rows: row0, row0 + 8

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_kt; ++j) {
    const uint32_t parity = j & 1;
    mbar_wait(k_full, parity);

    // ---- s = q k^T for this group's 16 keys over the full d -------------
    constexpr int NS = B_KW / 2;
    float s[NS];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int off = (ks / 4) * B_REGION + (ks % 4) * 32;
      wgmma_ss<B_KW, 0>(s, smem_desc(sq + off, 1, 64, 1),
                        smem_desc(sk + off + wg * B_KW * 128, 1, 64, 1),
                        ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(k_empty);

    // ---- online softmax with the row max shared across the groups -------
    const int k0 = j * B_BN + wg * B_KW;
    const bool ragged = j * B_BN + B_BN > S;
    float alpha[2] = {1.f, 1.f};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int key = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
      const float x = FAST ? fminf(fmaxf(s[i] * scale2, -FAST_CLAMP),
                                   FAST_CLAMP)
                           : s[i] * scale2;
      s[i] = (ragged && key >= S) ? -INFINITY : x;
    }
    if constexpr (!FAST) {
      float* smax = s_max + (j & 1) * 4 * 64;
      float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
      for (int i = 0; i < NS; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        if (t == 0) smax[wg * 64 + row0 + 8 * r] = mx[r];
      }
      named_bar_sync(1, B_CONSUMERS);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mn = m[r];
#pragma unroll
        for (int w = 0; w < 4; ++w) mn = fmaxf(mn, smax[w * 64 + row0 + 8 * r]);
        alpha[r] = fwd_exp2<POLY>(m[r] - mn);
        m[r] = mn;
      }
    }
    float rs[2] = {0.f, 0.f};  // p = exp2(s - m), m = 0 under FAST
    if constexpr (POLY == 0) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
        rs[(i >> 1) & 1] += s[i];
      }
    } else if (ragged) {  // a masked key's polynomial is 2^-126, not 0
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int key = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
        s[i] = key < S ? exp2_poly<POLY>(s[i] - m[(i >> 1) & 1]) : 0.f;
        rs[(i >> 1) & 1] += s[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i] = exp2_poly<POLY>(s[i] - m[(i >> 1) & 1]);
        rs[(i >> 1) & 1] += s[i];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
    if constexpr (!FAST) {
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }

    // ---- p (bf16) into the shared 64 x 64 tile, 128-byte swizzle ---------
    unsigned char* sp = smem + C::P_OFF + (j & 1) * B_REGION;
#pragma unroll
    for (int i = 0; i < NS; i += 2) {
      const int row = row0 + 8 * ((i >> 1) & 1);
      const int col = wg * B_KW + (i >> 2) * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(
          sp + row * 128 + (((col >> 3) ^ (row & 7)) << 4) + (col & 7) * 2) =
          pack_bf16(s[i], s[i + 1]);
    }
    fence_proxy_async();
    named_bar_sync(1, B_CONSUMERS);

    // ---- acc += p v over all 64 keys, this group's D/4 columns ------------
    mbar_wait(v_full, parity);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < B_BN / 16; ++kc)
      wgmma_ss<C::DW, 1>(
          acc, smem_desc(sp + kc * 32, 1, 64, 1),
          smem_desc(sv + (wg * C::DW / 64) * B_REGION + kc * 16 * 128,
                    B_REGION / 16, 64, 1),
          1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(v_empty);
  }

  // ---- o = acc / l, l summed over the groups in a fixed order -------------
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (t == 0) s_sum[wg * 64 + row0 + 8 * r] = l[r];
  }
  named_bar_sync(1, B_CONSUMERS);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + 8 * r;
    if (row >= S) continue;
    const int rr = row0 + 8 * r;
    const float inv = 1.f / (((s_sum[rr] + s_sum[64 + rr]) + s_sum[128 + rr]) +
                             s_sum[192 + rr]);
    __nv_bfloat16* orow = o + (int64_t(bh) * S + row) * D + wg * C::DW;
#pragma unroll
    for (int jn = 0; jn < C::DW / 8; ++jn)
      *reinterpret_cast<__nv_bfloat162*>(orow + jn * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[4 * jn + 2 * r] * inv,
                                acc[4 * jn + 2 * r + 1] * inv);
  }
}

template <int D, int POLY>
int launch_b_sm90(const void* q, const void* k, const void* v, void* o,
                  int bh, int s, float scale2, int fast, cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  if (make_tensor_map(&mq, q, bh, s, D, 64, B_BM) ||
      make_tensor_map(&mk, k, bh, s, D, 64, B_BN) ||
      make_tensor_map(&mv, v, bh, s, D, 64, B_BN))
    return kTmaEncodeFailed;
  auto kernel = fast ? flash_fwd_b_sm90<D, true, POLY>
                     : flash_fwd_b_sm90<D, false, POLY>;
  const dim3 grid((s + B_BM - 1) / B_BM, bh);
  return launch_kernel(kernel, grid, B_THREADS, BCfg<D>::SMEM, st, mq, mk,
                       mv, static_cast<__nv_bfloat16*>(o), s, scale2);
}

}  // namespace

namespace smtl {

// The instances of one degree: d in {256, 512}, the VAE mid blocks of the
// small and full presets. f32: the first-version template, 64-column d_v
// chunks across CTAs, 32-key tiles.
template <int POLY>
int launch_b(const void* q, const void* k, const void* v, void* o, int bh,
             int s, int d, int dtype, float scale2, int fast,
             cudaStream_t st) {
  if (dtype == 1 && d == 256)
    return launch_b_sm90<256, POLY>(q, k, v, o, bh, s, scale2, fast, st);
  if (dtype == 1 && d == 512)
    return launch_b_sm90<512, POLY>(q, k, v, o, bh, s, scale2, fast, st);
  if (dtype == 0 && d == 256)
    return launch_mode<256, 64, STREAM_F32_BN, false, POLY>(
        q, k, v, o, bh, s, scale2, fast, st);
  if (dtype == 0 && d == 512)
    return launch_mode<512, 64, STREAM_F32_BN, false, POLY>(
        q, k, v, o, bh, s, scale2, fast, st);
  return kBadArgument;
}

}  // namespace smtl

#define SMTL_LAUNCH_B_ARGS                                                  \
  const void*, const void*, const void*, void*, int, int, int, int, float, \
      int, cudaStream_t

// A variant's part (SMTL_POLY and SMTL_LSUM defined, ops/cuda_build.py's
// PARTS) instantiates that variant; the source without defines holds the
// entry point and the default's instances.
#ifdef SMTL_POLY
template int smtl::launch_b<SMTL_POLY>(SMTL_LAUNCH_B_ARGS);
#else
extern template int smtl::launch_b<3>(SMTL_LAUNCH_B_ARGS);
extern template int smtl::launch_b<4>(SMTL_LAUNCH_B_ARGS);

// poly in {0, 3, 4}; any other returns kBadVariant.
extern "C" int smtl_flash_fwd_b(const void* q, const void* k, const void* v,
                                void* o, int bh, int s, int d, int dtype,
                                int fast, int poly, float scale2,
                                void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (poly == 0)
    return smtl::launch_b<0>(q, k, v, o, bh, s, d, dtype, scale2, fast, st);
  if (poly == 3)
    return smtl::launch_b<3>(q, k, v, o, bh, s, d, dtype, scale2, fast, st);
  if (poly == 4)
    return smtl::launch_b<4>(q, k, v, o, bh, s, d, dtype, scale2, fast, st);
  return kBadVariant;
}
#endif
