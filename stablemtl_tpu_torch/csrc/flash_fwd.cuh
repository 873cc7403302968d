// Flash-attention forward, first version, float32 only: softmax(q k^T
// d^-1/2) v with scalar f32 FMAs (sm_90a). It is the f32 instance of the
// forward kernels, whose bf16 instances are Hopper kernels:
//   kernel A, K1 <- _fa_kernel_nolse (flash_fwd_a.cu);
//   K3           <- _fa_kernel with its logsumexp output (flash_fwd_lse.cu);
//   kernel B, K2 <- _fa_stream_kernel (flash_fwd_b.cu);
// all in stablemtl_tpu/ops/flash_attention.py. wgmma has no f32 form and
// TF32 would break the f32 checks: the f32 path exists for checking, not
// for speed, and nothing bounds it but its scalar FMAs.
//
// Arithmetic (as the TPU kernels): scores in f32 scaled by d^-1/2 * log2(e),
// online softmax in base 2, o = acc / l. FAST (STABLEMTL_FLASH_FAST_SOFTMAX)
// drops the running max: p = exp2(clamp(s, -110, 110)). With LSE, row r
// also stores the base-2 logsumexp m + log2(l) (log2(l) under FAST, where
// m = 0), the residual the backward kernels read. POLY (3, 4;
// STABLEMTL_FLASH_POLY_EXP) takes every exp2, p and the rescale alpha, from
// the polynomial of flash_common.cuh, as the JAX kernels do; a masked key's
// p stays 0 (the polynomial of -inf is 2^-126). STABLEMTL_FLASH_MXU_LSUM has
// no instance here: in f32 the ones column's sum of p is this row sum, up
// to order, so its callers take the default.
//
// Design. One CTA of 4 warps per (bh, 64-row q tile, d_v chunk); each warp
// owns 16 q rows. K and V stream through shared memory in BN-key tiles,
// loaded synchronously between two __syncthreads (V stored transposed);
// scores, probabilities and the output accumulator stay in registers in the
// m16n8k16 fragment layout of flash_common.cuh, and p goes through a
// per-warp shared-memory tile for the p v product. Keys and rows past S are
// masked, so S need not be a multiple of the tile. d larger than a thread's
// registers hold (kernel B, d = 256, 512) is split across CTAs (gridDim.y =
// d / DV), each recomputing the full-d scores.

#pragma once

#include "flash_common.cuh"

namespace {

template <int D, int DV, int BN>
struct Cfg {
  static constexpr int SQ = D + PAD;   // row stride of sQ, sK
  static constexpr int SV = BN + PAD;  // row stride of sVt ([DV][BN])
  static constexpr int SP = BN + 4;    // row stride of sP (f32 path)
  static constexpr size_t q_elems = size_t(BLOCK_M) * SQ;
  static constexpr size_t k_elems = size_t(BN) * SQ;
  static constexpr size_t v_elems = size_t(DV) * SV;
  static constexpr size_t p_floats = size_t(NWARPS) * 16 * SP;
  static constexpr size_t smem_bytes =
      (q_elems + k_elems + v_elems + p_floats) * sizeof(float);
  static_assert(D % 16 == 0 && DV % 8 == 0 && D % DV == 0, "tile shape");
  static_assert(BN % 16 == 0, "key tile");
  static_assert((SQ * sizeof(float)) % 16 == 0, "16-byte rows");
};

template <int D, int DV, int BN, bool FAST, bool LSE, int POLY>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int S, float scale2) {
  using T = float;
  using C = Cfg<D, DV, BN>;
  constexpr int NT_S = BN / 8;  // score n-tiles per warp
  constexpr int NT_O = DV / 8;  // output n-tiles per warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + C::q_elems;
  T* sVt = sK + C::k_elems;
  float* sP = reinterpret_cast<float*>(sVt + C::v_elems);

  const int q0 = blockIdx.x * BLOCK_M;
  const int dv0 = blockIdx.y * DV;
  const int64_t base = int64_t(blockIdx.z) * S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int wrow = warp * 16;  // first q row of this warp in the tile

  load_rows<T, D, C::SQ>(sQ, q + base + int64_t(q0) * D, D, BLOCK_M,
                         S - q0);

  float m[2] = {FAST ? 0.f : NEG_BIG, FAST ? 0.f : NEG_BIG};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums
  float acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int n_kt = (S + BN - 1) / BN;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // previous tiles fully consumed
    load_rows<T, D, C::SQ>(sK, k + base + int64_t(k0) * D, D, BN, S - k0);
    load_transposed<T, DV, C::SV>(sVt, v + base + int64_t(k0) * D + dv0, D,
                                  BN, S - k0);
    __syncthreads();

    // ---- s = q k^T over the full d --------------------------------------
    float s[NT_S][4];
#pragma unroll
    for (int i = 0; i < NT_S; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    warp_gemm_nt<D, NT_S, C::SQ, C::SQ>(s, sQ + wrow * C::SQ, sK);

    // ---- online softmax (base 2), masked tail ---------------------------
    float alpha[2] = {1.f, 1.f};
    if constexpr (!FAST) {
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + nt * 8 + tig * 2 + (e & 1);
          s[nt][e] = col < S ? s[nt][e] * scale2 : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = fwd_exp2<POLY>(m[r] - mx[r]);
        m[r] = mx[r];
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p;
        if constexpr (FAST) {
          const int col = k0 + nt * 8 + tig * 2 + (e & 1);
          p = col < S ? fwd_exp2<POLY>(fminf(
                            fmaxf(s[nt][e] * scale2, -FAST_CLAMP), FAST_CLAMP))
                      : 0.f;
        } else if constexpr (POLY == 0) {
          p = exp2f(s[nt][e] - m[e >> 1]);
        } else {  // the polynomial of a masked key's -inf is not 0
          const int col = k0 + nt * 8 + tig * 2 + (e & 1);
          p = col < S ? exp2_poly<POLY>(s[nt][e] - m[e >> 1]) : 0.f;
        }
        s[nt][e] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] *= alpha[r];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      l[0] += s[nt][0] + s[nt][1];
      l[1] += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int i = 0; i < NT_O; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // ---- acc += p v ------------------------------------------------------
    warp_gemm_pv<BN, NT_O, C::SV, C::SP>(acc, s, sVt,
                                         sP + warp * 16 * C::SP);
  }

  // ---- o = acc / l (and the row's logsumexp) ------------------------------
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + r * 8;
    if (row >= S) continue;
    if constexpr (LSE) {
      if (tig == 0 && blockIdx.y == 0)
        lse[int64_t(blockIdx.z) * S + row] = m[r] + log2f(l[r]);
    }
    const float inv = 1.f / l[r];
    T* orow = o + base + int64_t(row) * D + dv0;
#pragma unroll
    for (int dt = 0; dt < NT_O; ++dt) {
      *reinterpret_cast<float2*>(orow + dt * 8 + tig * 2) =
          make_float2(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    }
  }
}

// q, k, v, o: contiguous [bh, s, d] f32; lse: contiguous [bh, s] f32 when
// LSE, else unused. Returns the launch's cudaError_t (0 on success).
template <int D, int DV, int BN, bool LSE = false, int POLY = 0>
int launch_mode(const void* q, const void* k, const void* v, void* o, int bh,
                int s, float scale2, int fast, cudaStream_t stream,
                void* lse = nullptr) {
  using C = Cfg<D, DV, BN>;
  const dim3 grid((s + BLOCK_M - 1) / BLOCK_M, D / DV, bh);
  auto kernel = flash_fwd_kernel<D, DV, BN, false, LSE, POLY>;
  if (fast) kernel = flash_fwd_kernel<D, DV, BN, true, LSE, POLY>;
  return launch_kernel(kernel, grid, NTHREADS, C::smem_bytes, stream,
                       static_cast<const float*>(q),
                       static_cast<const float*>(k),
                       static_cast<const float*>(v), static_cast<float*>(o),
                       static_cast<float*>(lse), s, scale2);
}

}  // namespace
