// Kernel A's Hopper template: the bf16 flash-attention forward for the
// UNet's self-attention (head dim 64 at SD2 width; 16 and 32 for the tiny
// and small presets), softmax(q k^T d^-1/2) v with the base-2 online
// softmax and, under FAST, the max-free p = exp2(clamp(s, +-110)); with LSE
// it also writes each row's base-2 logsumexp. Two sources build it:
// flash_fwd_a.cu (K1, no LSE, two consumers) and flash_fwd_lse.cu (K3, the
// training forward, with LSE, three consumers).
//
// What bounds it on the H100. Per head, 4 S^2 d FLOPs on the tensor cores
// and S^2 exp2 on the special-function units. At [35, 4096, 64]:
// 4 * 4096^2 * 64 * 35 = 1.50e11 FLOPs / 989e12 FLOP/s = 0.152 ms, and
// 4096^2 * 35 = 5.87e8 exp2 / 4.19e12 per s (16 a clock an SM at the
// 1.98 GHz of the data sheet's FP32 rate) = 0.140 ms; q, k, v and o once
// are 73 MB, 0.022 ms at 3.35 TB/s. Nearly as much exp2 as tensor-core
// work: reaching the bound needs one warpgroup's exp2 to run while
// another's products run.
//
// Design (the shape FlashAttention-3 uses). A CTA owns 64 * NC q rows of
// one head and runs NC + 1 warpgroups:
//   - a producer (warpgroup NC, one thread working) that loads the CTA's q
//     once and then K and V tiles of 128 keys by TMA into a ring of
//     A_STAGES stages, each guarded by a full and an empty mbarrier; it
//     gives registers back with setmaxnreg;
//   - NC consumers of 64 q rows each. s = q k^T is one wgmma m64n128k16
//     chain from shared memory (q and k K-major); the online softmax runs
//     on s in registers; p, rounded to bf16, stays in registers as the A
//     operand of the p v wgmma (the RS form), whose B is the V tile read
//     MN-major as TMA wrote it, so V is never transposed. Named barriers
//     pass a turn round the consumers: each starts its q k^T after the
//     previous one has issued its own, so one's products run while
//     another's exp2 runs.
// The softmax runs in two passes in both modes (mask and scale, then
// exp2(s - m) with m = 0 under FAST): written as one pass per element, the
// fast instance measured 1.17 ms against 0.46 at [35, 4096, 64] on the
// H100 (PERF.md). Keys past S arrive as TMA zero fill and are masked (-inf,
// or p = 0 under FAST); rows past S are not stored.
//
// NC = 3 (192-row CTAs, FlashAttention-3's tile for head dim 64) is K3's:
// its training shape [10, 1728, 64] is 140 CTAs of 128 rows on 132 SMs (two
// waves, the second of 8 CTAs) but 90 of 192 rows (one wave of 1.5x the
// work). Three consumers share the register file at 160 registers each
// (the producer 32).
//
// The JAX package's two forward variants, instances of their own (POLY,
// LSUM):
//   - POLY 3, 4 (STABLEMTL_FLASH_POLY_EXP): p and the rescale alpha from the
//     polynomial of flash_common.cuh (FP32 pipes) instead of the
//     special-function units; a masked key's p is set to 0 (the polynomial
//     of -inf is 2^-126). Per score it trades one exp2 (16 a clock an SM)
//     for eight FP32 operations (128 a clock) and two integer ones. What
//     bounds it then is instruction dispatch, not a pipe: every warp
//     instruction takes one of the SM's 4 dispatch slots a clock whichever
//     unit runs it, and ~10 more instructions a score cost more slots than
//     the exp2's own rate saved. On the H100 it made K1 29-36 % slower
//     at [35, 4096, 64] (PERF.md). As in JAX, the polynomial's alpha is
//     not exact (at 0 it is 1 - 7.7e-5 at POLY 3), so under the exact
//     softmax the result depends on the 128-key tile (A_BN,
//     flash_common.cuh).
//   - LSUM (STABLEMTL_FLASH_MXU_LSUM): the JAX kernel appends a ones column
//     to V so the row sum comes out of the P.V product. TMA cannot load a
//     65-wide row, so here each k16 chunk of p (the same bf16 registers as
//     the p v product's A) also goes through one wgmma m64n8k16 against an
//     8-wide tile of ones the CTA writes to shared memory once; its 4
//     accumulators, rescaled by alpha with acc, hold the row's whole sum in
//     every column, so the quad shuffle of l drops out. The row sum rides
//     the tensor cores, as the normaliser rides the MXU on the TPU: one
//     n8 product beside each n = d product, 1-3 % slower on the H100.

#pragma once

#include "sm90.cuh"

namespace {

constexpr int A_STAGES = 3;    // K/V ring depth

template <int D, int NC>
struct ACfg {
  static constexpr int BM = 64 * NC;      // q rows per CTA
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int CONSUMER_REGS = NC == 2 ? 232 : 160;
  static constexpr int PRODUCER_REGS = NC == 2 ? 40 : 32;
  static constexpr int ROW = D * 2;  // bytes per row = swizzle span
  static constexpr int LAYOUT = swizzle_layout(ROW);
  static constexpr int SBO = 8 * ROW / 16;  // 8-row groups, 16-byte units
  static constexpr int Q_BYTES = BM * ROW;
  static constexpr int KV_BYTES = A_BN * ROW;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + A_STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + A_STAGES * KV_BYTES;
  // q_full, full[A_STAGES], empty[A_STAGES]; 1024 bytes of alignment slack
  static constexpr size_t SMEM = BAR_OFF + (1 + 2 * A_STAGES) * 8 + 1024;
  // LSUM: the ones tile of the row-sum product (512 bytes, read as two
  // 128-byte core matrices) after the barriers
  static constexpr int ONES_OFF = BAR_OFF + 128;
  static constexpr int ONES_BYTES = 512;
  static constexpr size_t SMEM_LSUM = ONES_OFF + ONES_BYTES + 1024;
  static_assert(D == 16 || D == 32 || D == 64, "head dim");
  static_assert(NC == 2 || NC == 3, "consumer warpgroups");
  static_assert((CONSUMER_REGS * NC + PRODUCER_REGS) * 128 <= 65536,
                "register file");
  static_assert(KV_BYTES % 1024 == 0 && (64 * ROW) % 1024 == 0,
                "alignment");
};

template <int D, int NC, bool FAST, bool LSE, int POLY, bool LSUM>
__global__ void __launch_bounds__(ACfg<D, NC>::THREADS, 1)
flash_fwd_a_sm90(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int S, float scale2) {
  using C = ACfg<D, NC>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + A_STAGES;

  const int q0 = blockIdx.x * C::BM, bh = blockIdx.y;
  const int n_kt = (S + A_BN - 1) / A_BN;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < A_STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4 * NC);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  if constexpr (LSUM) {  // bf16 1.0 pairs, visible to wgmma after the fence
    if (threadIdx.x < C::ONES_BYTES / 4)
      reinterpret_cast<uint32_t*>(smem + C::ONES_OFF)[threadIdx.x] =
          0x3F803F80u;
    fence_proxy_async();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    // ---- producer ---------------------------------------------------------
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 128 * NC) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      tma_load_3d(smem, &map_q, q_full, 0, q0, bh);
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % A_STAGES;
        mbar_wait(&empty[st], ((j / A_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * C::KV_BYTES);
        tma_load_3d(smem + C::K_OFF + st * C::KV_BYTES, &map_k, &full[st], 0,
                    j * A_BN, bh);
        tma_load_3d(smem + C::V_OFF + st * C::KV_BYTES, &map_v, &full[st], 0,
                    j * A_BN, bh);
      }
    }
  } else {
    // ---- consumers --------------------------------------------------------
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    constexpr int NS = A_BN / 2;  // score registers: 64 x 128 per group
    constexpr int NO = D / 2;     // output registers: 64 x D per group
    // the turn passes 0 -> 1 -> ... -> NC - 1 -> 0 on named barriers
    // 1..NC; each wait pairs 128 waiting threads with 128 arriving ones
    const int next_turn = 1 + (wg + 1) % NC;

    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    float m[2] = {FAST ? 0.f : NEG_BIG, FAST ? 0.f : NEG_BIG};
    float l[2] = {0.f, 0.f};  // per-thread partial row sums
    // LSUM: the ones product's accumulators (rows g and g + 8, whole sums)
    float lacc[4] = {0.f, 0.f, 0.f, 0.f};
    const uint64_t desc_ones = smem_desc(smem + C::ONES_OFF, 8, 8, 0);

    const uint64_t desc_q =
        smem_desc(smem + wg * 64 * C::ROW, 1, C::SBO, C::LAYOUT);
    mbar_wait(q_full, 0);
    if (wg == NC - 1) named_bar_arrive(1, 256);  // consumer 0 goes first

    for (int j = 0; j < n_kt; ++j) {
      const int st = j % A_STAGES;
      mbar_wait(&full[st], (j / A_STAGES) & 1);
      const unsigned char* sk = smem + C::K_OFF + st * C::KV_BYTES;
      const unsigned char* sv = smem + C::V_OFF + st * C::KV_BYTES;

      // ---- s = q k^T (wgmma from shared memory, both K-major) ------------
      float s[NS];
      named_bar_sync(1 + wg, 256);
      wgmma_fence();
      const uint64_t desc_k = smem_desc(sk, 1, C::SBO, C::LAYOUT);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)  // +32 bytes per k16 step
        wgmma_ss<A_BN, 0>(s, desc_q + 2 * ks, desc_k + 2 * ks, ks > 0);
      wgmma_commit();
      // the next consumer may start its products now; the last consumer's
      // last arrival would find no partner
      if (!(wg == NC - 1 && j == n_kt - 1)) named_bar_arrive(next_turn, 256);
      wgmma_wait<0>();
      fence_regs(s);

      // ---- online softmax (base 2), masked tail ---------------------------
      const int k0 = j * A_BN;
      const bool ragged = k0 + A_BN > S;
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
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < NS; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = fwd_exp2<POLY>(m[r] - mx[r]);
          m[r] = mx[r];
        }
      }
      float rs[2] = {0.f, 0.f};  // p = exp2(s - m), m = 0 under FAST
      if constexpr (POLY == 0) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
          if constexpr (!LSUM) rs[(i >> 1) & 1] += s[i];
        }
      } else if (ragged) {  // a masked key's polynomial is 2^-126, not 0
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int key = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
          s[i] = key < S ? exp2_poly<POLY>(s[i] - m[(i >> 1) & 1]) : 0.f;
          if constexpr (!LSUM) rs[(i >> 1) & 1] += s[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          s[i] = exp2_poly<POLY>(s[i] - m[(i >> 1) & 1]);
          if constexpr (!LSUM) rs[(i >> 1) & 1] += s[i];
        }
      }
      if constexpr (!LSUM) {
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
      }
      if constexpr (!FAST) {
#pragma unroll
        for (int i = 0; i < NO; ++i) acc[i] *= alpha[(i >> 1) & 1];
        if constexpr (LSUM) {
#pragma unroll
          for (int i = 0; i < 4; ++i) lacc[i] *= alpha[(i >> 1) & 1];
        }
      }

      // ---- acc += p v: p (bf16) from registers, V MN-major ----------------
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < A_BN / 16; ++kc) {
        const uint32_t a[4] = {pack_bf16(s[8 * kc], s[8 * kc + 1]),
                               pack_bf16(s[8 * kc + 2], s[8 * kc + 3]),
                               pack_bf16(s[8 * kc + 4], s[8 * kc + 5]),
                               pack_bf16(s[8 * kc + 6], s[8 * kc + 7])};
        wgmma_rs<D, 1>(acc, a,
                       smem_desc(sv + kc * 16 * C::ROW, 1, C::SBO, C::LAYOUT),
                       1);
        if constexpr (LSUM) wgmma_rs<8, 0>(lacc, a, desc_ones, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if constexpr (LSUM) fence_regs(lacc);
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // ---- o = acc / l (and, with LSE, the row's logsumexp) -----------------
    if constexpr (LSUM) {
      l[0] = lacc[0];
      l[1] = lacc[2];
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wg * 64 + warp * 16 + g + 8 * r;
      if (row >= S) continue;
      if constexpr (LSE) {
        if (t == 0) lse[int64_t(bh) * S + row] = m[r] + log2f(l[r]);
      }
      const float inv = 1.f / l[r];
      __nv_bfloat16* orow = o + (int64_t(bh) * S + row) * D;
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn)
        *reinterpret_cast<__nv_bfloat162*>(orow + jn * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[4 * jn + 2 * r] * inv,
                                  acc[4 * jn + 2 * r + 1] * inv);
    }
  }
}

template <int D, int NC, bool LSE, int POLY, bool LSUM>
int launch_a_sm90(const void* q, const void* k, const void* v, void* o,
                  void* lse, int bh, int s, float scale2, int fast,
                  cudaStream_t st) {
  using C = ACfg<D, NC>;
  CUtensorMap mq, mk, mv;
  if (make_tensor_map(&mq, q, bh, s, D, D, C::BM) ||
      make_tensor_map(&mk, k, bh, s, D, D, A_BN) ||
      make_tensor_map(&mv, v, bh, s, D, D, A_BN))
    return kTmaEncodeFailed;
  auto kernel = fast ? flash_fwd_a_sm90<D, NC, true, LSE, POLY, LSUM>
                     : flash_fwd_a_sm90<D, NC, false, LSE, POLY, LSUM>;
  const dim3 grid((s + C::BM - 1) / C::BM, bh);
  return launch_kernel(kernel, grid, C::THREADS,
                       LSUM ? C::SMEM_LSUM : C::SMEM, st, mq, mk, mv,
                       static_cast<__nv_bfloat16*>(o),
                       static_cast<float*>(lse), s, scale2);
}

}  // namespace
