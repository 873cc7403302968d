// Flash-attention forward, first version (mma.sync, synchronous loads):
// softmax(q k^T d^-1/2) v on Hopper (sm_90a).
//
// Replaces, for the instances still built from it, the Pallas TPU kernels of
// stablemtl_tpu/ops/flash_attention.py:
//   K3        <- _fa_kernel with its logsumexp output (the training forward,
//                via _flash_fwd): every instance, bf16 and f32
//                (flash_fwd_lse.cu);
//   kernel A  <- _fa_kernel_nolse: the float32 instances only
//                (flash_fwd_a.cu);
//   kernel B  <- _fa_stream_kernel: the float32 instances only
//                (flash_fwd_b.cu).
// The bf16 kernels A and B are the Hopper redesign of flash_fwd_a.cu and
// flash_fwd_b.cu (TMA and wgmma, sm90.cuh). Why these stay here: wgmma
// has no f32 form and TF32 would break the f32 checks (the f32 path exists
// for checking, not for speed); K3 is the next kernel to move onto kernel
// A's new design, whose LSE flag is kept for it. Its bf16 body here is
// compiled into K3's library only.
//
// Arithmetic (as the TPU kernels): scores in f32 scaled by d^-1/2 * log2(e),
// online softmax in base 2, products in the input dtype with f32
// accumulation, o = acc / l. FAST (STABLEMTL_FLASH_FAST_SOFTMAX) drops the
// running max: p = exp2(clamp(s, -110, 110)). With LSE, row r also stores
// the base-2 logsumexp m + log2(l) in f32 (log2(l) under FAST, where m = 0),
// the residual the backward kernels read.
//
// Design. One CTA of 4 warps per (bh, 64-row q tile, d_v chunk); each warp
// owns 16 q rows. K and V stream through shared memory in BN-key tiles,
// loaded synchronously between two __syncthreads (V stored transposed so its
// mma B fragments are single 32-bit loads); scores, probabilities and the
// output accumulator stay in registers in the mma.sync m16n8k16 fragment
// layout (flash_common.cuh), so P feeds the P.V product without a trip
// through shared memory. The bf16 tile products are written out here rather
// than through flash_common.cuh's warp helpers: routed through the helpers,
// the fast-softmax instance at d=64 measured 1.62 ms against 1.29 ms for
// bit-equal output on the H100 (PERF.md). Keys and rows past S are masked,
// so S need not be a multiple of the tile (the eval geometries give S=1672,
// 6688). d larger than a thread's registers hold (kernel B's f32 instances,
// d = 256, 512) is split across CTAs (gridDim.y = d / DV), each recomputing
// the full-d scores.
//
// What bounds it on the H100. At d=64 each score costs 4*64 tensor-core
// FLOPs and one exp2: 989 TFLOP/s bf16 and the ~3.9e12 exp2/s of the
// special-function units bound it about equally (K3 at [10, 1728, 64]:
// 4 * 1728^2 * 64 * 10 = 7.6e9 FLOPs, 7.7 us); bytes (q, k, v, o once) are
// far below both. Without wgmma or pipelined loads this version reaches a
// fraction of either bound; the measured times are in PERF.md.

#pragma once

#include "flash_common.cuh"

namespace {

template <typename T, int D, int DV, int BN>
struct Cfg {
  static constexpr int SQ = D + PAD;   // row stride of sQ, sK
  static constexpr int SV = BN + PAD;  // row stride of sVt ([DV][BN])
  static constexpr int SP = BN + 4;    // row stride of sP (f32 path)
  static constexpr size_t q_elems = size_t(BLOCK_M) * SQ;
  static constexpr size_t k_elems = size_t(BN) * SQ;
  static constexpr size_t v_elems = size_t(DV) * SV;
  static constexpr size_t p_floats =
      std::is_same<T, float>::value ? size_t(NWARPS) * 16 * SP : 0;
  static constexpr size_t smem_bytes =
      (q_elems + k_elems + v_elems) * sizeof(T) + p_floats * sizeof(float);
  static_assert(D % 16 == 0 && DV % 8 == 0 && D % DV == 0, "tile shape");
  static_assert(BN % 16 == 0, "key tile");
  static_assert((SQ * sizeof(T)) % 16 == 0, "16-byte rows");
};

template <typename T, int D, int DV, int BN, bool FAST, bool LSE>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, float scale2) {
  using C = Cfg<T, D, DV, BN>;
  constexpr bool F32 = std::is_same<T, float>::value;
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
    if constexpr (!F32) {
#pragma unroll 4
      for (int ks = 0; ks < D / 16; ++ks) {
        const T* qa = sQ + (wrow + g) * C::SQ + ks * 16 + tig * 2;
        const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * C::SQ);
        const uint32_t a2 = ld32(qa + 8), a3 = ld32(qa + 8 * C::SQ + 8);
#pragma unroll
        for (int nt = 0; nt < NT_S; ++nt) {
          const T* kb = sK + (nt * 8 + g) * C::SQ + ks * 16 + tig * 2;
          mma16816(s[nt], a0, a1, a2, a3, ld32(kb), ld32(kb + 8));
        }
      }
    } else {
      warp_gemm_nt<T, D, NT_S, C::SQ, C::SQ>(s, sQ + wrow * C::SQ, sK);
    }

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
        alpha[r] = exp2f(m[r] - mx[r]);
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
          p = col < S ? exp2f(fminf(fmaxf(s[nt][e] * scale2, -FAST_CLAMP),
                                    FAST_CLAMP))
                      : 0.f;
        } else {
          p = exp2f(s[nt][e] - m[e >> 1]);
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

    // ---- acc += p v (p rounded to the input dtype, as on the TPU) -------
    if constexpr (!F32) {
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        const uint32_t a0 = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
        const uint32_t a1 = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
        const uint32_t a2 = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        const uint32_t a3 = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
        for (int dt = 0; dt < NT_O; ++dt) {
          const T* vb = sVt + (dt * 8 + g) * C::SV + kc * 16 + tig * 2;
          mma16816(acc[dt], a0, a1, a2, a3, ld32(vb), ld32(vb + 8));
        }
      }
    } else {
      warp_gemm_pv<T, BN, NT_O, C::SV, C::SP>(acc, s, sVt,
                                              sP + warp * 16 * C::SP);
    }
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
      const float x0 = acc[dt][2 * r] * inv, x1 = acc[dt][2 * r + 1] * inv;
      if constexpr (F32) {
        *reinterpret_cast<float2*>(orow + dt * 8 + tig * 2) =
            make_float2(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + tig * 2) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o: contiguous [bh, s, d]; lse:
// contiguous [bh, s] f32 when LSE, else unused. Returns the launch's
// cudaError_t (0 on success).
template <typename T, int D, int DV, int BN, bool LSE = false>
int launch_mode(const void* q, const void* k, const void* v, void* o, int bh,
                int s, float scale2, int fast, cudaStream_t stream,
                void* lse = nullptr) {
  using C = Cfg<T, D, DV, BN>;
  const dim3 grid((s + BLOCK_M - 1) / BLOCK_M, D / DV, bh);
  auto kernel = flash_fwd_kernel<T, D, DV, BN, false, LSE>;
  if (fast) kernel = flash_fwd_kernel<T, D, DV, BN, true, LSE>;
  return launch_kernel(kernel, grid, NTHREADS, C::smem_bytes, stream,
                       static_cast<const T*>(q), static_cast<const T*>(k),
                       static_cast<const T*>(v), static_cast<T*>(o),
                       static_cast<float*>(lse), s, scale2);
}

}  // namespace
