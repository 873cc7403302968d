// The Hopper template of the bf16 flash-attention backward, built by
// flash_bwd_dq.cu (K4: dQ) and flash_bwd_dkv.cu (K5: dK and dV). Both
// recompute the forward's probabilities from q, k, the base-2 logsumexp lse
// and delta = rowsum(dO o O):
//   p  = exp2(q.k * d^-1/2 * log2(e) - lse)   (no clamp, as JAX)
//   dp = dO . v,   ds = p o (dp - delta)
// with p and ds rounded to bf16 before their products, f32 accumulation,
// and dQ = d^-1/2 sum_keys ds k, dK = d^-1/2 sum_q ds^T q, dV = sum_q p^T dO.
// As in JAX the two are separate kernels with no atomics: each output row
// is summed by one thread in one fixed order, so both are deterministic.
//
// What bounds it on the H100. Per head, K4 does 6 S^2 d FLOPs and K5
// 8 S^2 d on the tensor cores, and each S^2 exp2 on the special-function
// units. At [10, 1728, 64]: 1.15e10 FLOPs / 989e12 FLOP/s = 0.0116 ms (K4)
// and 0.0155 ms (K5) against 0.0077 ms of exp2; the bytes (q, k, v, dO, the
// outputs, lse and delta once, ~9 MB) take 0.003 ms. So tensor cores first
// and exp2 close behind: one consumer's exp2 has to run while another's
// products run.
//
// Design (kernel A's, flash_fwd_a_sm90.cuh). A CTA owns 64 * NC RESIDENT
// rows of one head and runs NC + 1 warpgroups:
//   - a producer warpgroup (registers given back with setmaxnreg): one
//     thread loads the two resident tiles once and then two STREAMED tiles
//     of 64 rows at a time by TMA into a ring of BWD_STAGES stages, each
//     guarded by a full and an empty mbarrier; for K5 a second warp writes
//     each stage's 64 lse and delta values with plain guarded loads (a
//     [bh, S] f32 row is 16-byte aligned only when S % 4 == 0, so no TMA);
//   - NC consumer warpgroups of 64 resident rows each. Per streamed tile,
//     two SS wgmma chains m64n64k16 (both operands K-major, d contiguous,
//     as the tiles lie in memory) give the scores and dp in registers; p
//     and ds, rounded to bf16, are the A operand of RS wgmma chains with
//     N = d whose B operand is a streamed tile read MN-major (depth = the
//     streamed rows). One shared-memory tile serves as a K-major and as an
//     MN-major operand through two descriptors, so nothing is transposed or
//     copied twice. Named barriers pass a turn round the consumers, so
//     one's products run under another's exp2. NC = 3 (192 resident rows,
//     90 CTAs at the training shape on 132 SMs, one wave) for both: on the
//     H100 it beat NC = 2 at [10, 1728, 64] and [35, 4096, 64] and lost by
//     4-8 % at [70, 1024, 64] (PERF.md).
//   Measured orders (PERF.md): K4 commits the two SS chains as two groups
//     and forms p while dp's products run (5-6 % faster than one group);
//     K5 waits for both, as a K5 that also issued dV's chain before
//     waiting for dp made ptxas serialize its wgmma (too few registers at
//     160) and ran 6-10 % slower.
//   K4 (q-parallel): resident q and dO, streamed k and v; S = q k^T and
//     dP = dO v^T, then dQ += dS k. Each thread keeps its two rows' lse and
//     delta in registers.
//   K5 (key-parallel, the transposed frame): resident k and v, streamed q
//     and dO; S^T = k q^T and dP^T = v dO^T, whose accumulators are already
//     the A fragments of dV += P^T dO and dK += dS^T q (depth = q rows).
//     Four f32 accumulators a thread (S^T, dP^T, dK, dV: 128 registers at
//     d = 64, within the 160 of three consumers without a spill).
// Streamed rows past S arrive as TMA zero fill; their p is masked to 0
// explicitly (exp2(0 - lse) is not 0, and lse or delta past S belong to no
// row). Resident rows past S are computed on zeros and not stored.

#pragma once

#include "sm90.cuh"

namespace {

constexpr int BWD_BN = 64;     // streamed rows per tile
constexpr int BWD_STAGES = 4;  // ring depth

template <int D, int NC, bool DKV>
struct BwdCfg {
  static constexpr int BM = 64 * NC;  // resident rows per CTA
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int CONSUMER_REGS = NC == 2 ? 232 : 160;
  static constexpr int PRODUCER_REGS = NC == 2 ? 40 : 32;
  static constexpr int ROW = D * 2;  // bytes per row = swizzle span
  static constexpr int LAYOUT = swizzle_layout(ROW);
  static constexpr int SBO = 8 * ROW / 16;  // 8-row groups, 16-byte units
  static constexpr int RES_BYTES = BM * ROW;       // one resident tensor
  static constexpr int TILE_BYTES = BWD_BN * ROW;  // one streamed tile
  static constexpr int RES2_OFF = RES_BYTES;
  static constexpr int T1_OFF = 2 * RES_BYTES;
  static constexpr int T2_OFF = T1_OFF + BWD_STAGES * TILE_BYTES;
  // K5: each stage's lse[64] and delta[64]
  static constexpr int ROWS_OFF = T2_OFF + BWD_STAGES * TILE_BYTES;
  static constexpr int ROWS_BYTES = DKV ? BWD_STAGES * 2 * BWD_BN * 4 : 0;
  static constexpr int BAR_OFF = ROWS_OFF + ROWS_BYTES;
  // res_full, full[BWD_STAGES], empty[BWD_STAGES]; 1024 bytes of alignment
  // slack
  static constexpr size_t SMEM = BAR_OFF + (1 + 2 * BWD_STAGES) * 8 + 1024;
  static_assert(D == 16 || D == 32 || D == 64, "head dim");
  static_assert(NC == 2 || NC == 3, "consumer warpgroups");
  static_assert((CONSUMER_REGS * NC + PRODUCER_REGS) * 128 <= 65536,
                "register file");
  static_assert(TILE_BYTES % 1024 == 0 && (64 * ROW) % 1024 == 0,
                "alignment");
};

// out1 = dQ (K4) or dK (K5), out2 = dV (K5). map_r1, map_r2: the resident
// tensors (q and dO, or k and v) in boxes of 64 * NC rows; map_t1, map_t2:
// the streamed ones (k and v, or q and dO) in boxes of 64 rows.
template <int D, int NC, bool DKV>
__global__ void __launch_bounds__(BwdCfg<D, NC, DKV>::THREADS, 1)
flash_bwd_sm90(const __grid_constant__ CUtensorMap map_r1,
               const __grid_constant__ CUtensorMap map_r2,
               const __grid_constant__ CUtensorMap map_t1,
               const __grid_constant__ CUtensorMap map_t2,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ out1,
               __nv_bfloat16* __restrict__ out2, int S, float scale2,
               float scale) {
  using C = BwdCfg<D, NC, DKV>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  float* srows = reinterpret_cast<float*>(smem + C::ROWS_OFF);
  uint64_t* res_full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* full = res_full + 1;
  uint64_t* empty = full + BWD_STAGES;

  const int r0 = blockIdx.x * C::BM, bh = blockIdx.y;
  const int n_t = (S + BWD_BN - 1) / BWD_BN;
  const int64_t row_base = int64_t(bh) * S;
  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int st = 0; st < BWD_STAGES; ++st) {
      // K5: the TMA thread's arrival and one per lane of the row loader
      mbar_init(&full[st], DKV ? 1 + 32 : 1);
      mbar_init(&empty[st], 4 * NC);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    // ---- producer ---------------------------------------------------------
    setmaxnreg_dec<C::PRODUCER_REGS>();
    const int ptid = threadIdx.x - 128 * NC;
    if (ptid == 0) {
      mbar_expect_tx(res_full, 2 * C::RES_BYTES);
      tma_load_3d(smem, &map_r1, res_full, 0, r0, bh);
      tma_load_3d(smem + C::RES2_OFF, &map_r2, res_full, 0, r0, bh);
      for (int j = 0; j < n_t; ++j) {
        const int st = j % BWD_STAGES;
        mbar_wait(&empty[st], ((j / BWD_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * C::TILE_BYTES);
        tma_load_3d(smem + C::T1_OFF + st * C::TILE_BYTES, &map_t1,
                    &full[st], 0, j * BWD_BN, bh);
        tma_load_3d(smem + C::T2_OFF + st * C::TILE_BYTES, &map_t2,
                    &full[st], 0, j * BWD_BN, bh);
      }
    } else if (DKV && ptid / 32 == 1) {
      // the streamed q rows' lse and delta (0 past S, where p is masked)
      const int lane = ptid % 32;
      for (int j = 0; j < n_t; ++j) {
        const int st = j % BWD_STAGES;
        mbar_wait(&empty[st], ((j / BWD_STAGES) & 1) ^ 1);
        float* rows = srows + st * 2 * BWD_BN;
        for (int i = lane; i < BWD_BN; i += 32) {
          const int row = j * BWD_BN + i;
          const bool valid = row < S;
          rows[i] = valid ? lse[row_base + row] : 0.f;
          rows[BWD_BN + i] = valid ? delta[row_base + row] : 0.f;
        }
        mbar_arrive(&full[st]);  // releases this lane's stores
      }
    }
  } else {
    // ---- consumers --------------------------------------------------------
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    constexpr int NS = BWD_BN / 2;  // score registers: 64 x 64 per group
    constexpr int NO = D / 2;       // output registers: 64 x D per group
    // the turn passes 0 -> 1 -> ... -> NC - 1 -> 0 on named barriers
    // 1..NC; each wait pairs 128 waiting threads with 128 arriving ones
    const int next_turn = 1 + (wg + 1) % NC;
    // this thread's resident rows: row0 and row0 + 8
    const int row0 = r0 + wg * 64 + warp * 16 + g;

    float acc1[NO], acc2[DKV ? NO : 1];  // dQ or dK; dV
#pragma unroll
    for (int i = 0; i < NO; ++i) acc1[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (DKV ? NO : 1); ++i) acc2[i] = 0.f;
    // K4: the lse and delta of this thread's two q rows
    float row_lse[2] = {0.f, 0.f}, row_delta[2] = {0.f, 0.f};
    if constexpr (!DKV) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < S) {
          row_lse[r] = lse[row_base + row];
          row_delta[r] = delta[row_base + row];
        }
      }
    }

    const uint64_t desc_r1 =
        smem_desc(smem + wg * 64 * C::ROW, 1, C::SBO, C::LAYOUT);
    const uint64_t desc_r2 = smem_desc(
        smem + C::RES2_OFF + wg * 64 * C::ROW, 1, C::SBO, C::LAYOUT);
    mbar_wait(res_full, 0);
    if (wg == NC - 1) named_bar_arrive(1, 256);  // consumer 0 goes first

    for (int j = 0; j < n_t; ++j) {
      const int st = j % BWD_STAGES;
      mbar_wait(&full[st], (j / BWD_STAGES) & 1);
      const unsigned char* t1 = smem + C::T1_OFF + st * C::TILE_BYTES;
      const unsigned char* t2 = smem + C::T2_OFF + st * C::TILE_BYTES;

      // ---- s = r1 t1^T, dp = r2 t2^T (wgmma from shared memory) ----------
      // K4: S = q k^T, dP = dO v^T; K5: S^T = k q^T, dP^T = v dO^T
      float s[NS], dp[NS];
      named_bar_sync(1 + wg, 256);
      wgmma_fence();
      const uint64_t desc_t1 = smem_desc(t1, 1, C::SBO, C::LAYOUT);
      const uint64_t desc_t2 = smem_desc(t2, 1, C::SBO, C::LAYOUT);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)  // +32 bytes per k16 step
        wgmma_ss<BWD_BN, 0>(s, desc_r1 + 2 * ks, desc_t1 + 2 * ks, ks > 0);
      if constexpr (!DKV) wgmma_commit();  // K4: p is formed under dp's chain
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss<BWD_BN, 0>(dp, desc_r2 + 2 * ks, desc_t2 + 2 * ks, ks > 0);
      wgmma_commit();
      // the next consumer may start its products now; the last consumer's
      // last arrival would find no partner
      if (!(wg == NC - 1 && j == n_t - 1)) named_bar_arrive(next_turn, 256);

      // ---- p = exp2(s * scale2 - lse), masked past S ----------------------
      // register i holds resident row (i >> 1) & 1 (row0 or row0 + 8) and
      // streamed row 8 * (i >> 2) + 2t + (i & 1) of the tile
      wgmma_wait<DKV ? 0 : 1>();
      fence_regs(s);
      const int c0 = j * BWD_BN;
      const bool ragged = c0 + BWD_BN > S;
      // K5: lse and delta belong to the streamed q rows (the columns)
      const float2* rl =
          reinterpret_cast<const float2*>(srows + st * 2 * BWD_BN);
      const float2* rd = rl + BWD_BN / 2;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int col = c0 + 8 * (i >> 2) + 2 * t + (i & 1);
        float l;
        if constexpr (DKV) {
          const float2 l2 = rl[4 * (i >> 2) + t];
          l = (i & 1) ? l2.y : l2.x;
        } else {
          l = row_lse[(i >> 1) & 1];
        }
        const float x = s[i] * scale2 - l;
        s[i] = (ragged && col >= S) ? -INFINITY : x;
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = exp2f(s[i]);

      // ---- ds = p o (dp - delta) -----------------------------------------
      if constexpr (!DKV) wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        float dl;
        if constexpr (DKV) {
          const float2 d2 = rd[4 * (i >> 2) + t];
          dl = (i & 1) ? d2.y : d2.x;
        } else {
          dl = row_delta[(i >> 1) & 1];
        }
        dp[i] = s[i] * (dp[i] - dl);
      }

      // ---- out1 += ds t1 (K4: dQ += dS k; K5: dK += dS^T q) and, K5,
      // dV += P^T dO: A (bf16) from registers, B the streamed tile MN-major
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BWD_BN / 16; ++kc) {
        if constexpr (DKV) {
          const uint32_t a_p[4] = {pack_bf16(s[8 * kc], s[8 * kc + 1]),
                                   pack_bf16(s[8 * kc + 2], s[8 * kc + 3]),
                                   pack_bf16(s[8 * kc + 4], s[8 * kc + 5]),
                                   pack_bf16(s[8 * kc + 6], s[8 * kc + 7])};
          wgmma_rs<D, 1>(
              acc2, a_p,
              smem_desc(t2 + kc * 16 * C::ROW, 1, C::SBO, C::LAYOUT), 1);
        }
        const uint32_t a_ds[4] = {pack_bf16(dp[8 * kc], dp[8 * kc + 1]),
                                  pack_bf16(dp[8 * kc + 2], dp[8 * kc + 3]),
                                  pack_bf16(dp[8 * kc + 4], dp[8 * kc + 5]),
                                  pack_bf16(dp[8 * kc + 6], dp[8 * kc + 7])};
        wgmma_rs<D, 1>(acc1, a_ds,
                       smem_desc(t1 + kc * 16 * C::ROW, 1, C::SBO, C::LAYOUT),
                       1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc1);
      if constexpr (DKV) fence_regs(acc2);
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // ---- store the rows below S: out1 * scale, out2 -----------------------
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      __nv_bfloat16* o1 = out1 + (row_base + row) * D;
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn)
        *reinterpret_cast<__nv_bfloat162*>(o1 + jn * 8 + 2 * t) =
            __floats2bfloat162_rn(acc1[4 * jn + 2 * r] * scale,
                                  acc1[4 * jn + 2 * r + 1] * scale);
      if constexpr (DKV) {
        __nv_bfloat16* o2 = out2 + (row_base + row) * D;
#pragma unroll
        for (int jn = 0; jn < D / 8; ++jn)
          *reinterpret_cast<__nv_bfloat162*>(o2 + jn * 8 + 2 * t) =
              __floats2bfloat162_rn(acc2[4 * jn + 2 * r],
                                    acc2[4 * jn + 2 * r + 1]);
      }
    }
  }
}

// K4 (DKV false): out1 = dQ; K5: out1 = dK, out2 = dV.
template <int D, int NC, bool DKV>
int launch_bwd_sm90(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* out1, void* out2, int bh, int s, float scale2,
                    float scale, cudaStream_t st) {
  using C = BwdCfg<D, NC, DKV>;
  // K4 keeps q and dO resident and streams k and v; K5 the other way round
  const void* r1 = DKV ? k : q;
  const void* r2 = DKV ? v : dout;
  const void* t1 = DKV ? q : k;
  const void* t2 = DKV ? dout : v;
  CUtensorMap m_r1, m_r2, m_t1, m_t2;
  if (make_tensor_map(&m_r1, r1, bh, s, D, D, C::BM) ||
      make_tensor_map(&m_r2, r2, bh, s, D, D, C::BM) ||
      make_tensor_map(&m_t1, t1, bh, s, D, D, BWD_BN) ||
      make_tensor_map(&m_t2, t2, bh, s, D, D, BWD_BN))
    return kTmaEncodeFailed;
  const dim3 grid((s + C::BM - 1) / C::BM, bh);
  return launch_kernel(flash_bwd_sm90<D, NC, DKV>, grid, C::THREADS, C::SMEM,
                       st, m_r1, m_r2, m_t1, m_t2,
                       static_cast<const float*>(lse),
                       static_cast<const float*>(delta),
                       static_cast<__nv_bfloat16*>(out1),
                       static_cast<__nv_bfloat16*>(out2), s, scale2, scale);
}

}  // namespace
