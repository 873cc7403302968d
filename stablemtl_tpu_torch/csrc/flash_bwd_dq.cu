// K4: flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces stablemtl_tpu/ops/flash_attention.py::_fa_dq_kernel. For each
// (bh, 64-row q tile) it loops over 64-key tiles:
//   S  = Q K^T, dP = dO V^T                 (mma.sync m16n8k16, f32 acc)
//   P  = exp2(S * d^-1/2 * log2(e) - lse)   (lse: the forward's base-2
//                                            logsumexp; no clamp, as JAX)
//   dS = P o (dP - delta)                   (delta = rowsum(dO o O), f32)
//   dQ += dS K                              (dS rounded to the input dtype
//                                            and fed as the A fragment)
// and scales dQ by d^-1/2 at the end. Its partner K5 (flash_bwd_dkv.cu)
// computes dK and dV in a key-parallel grid; as in JAX the two are separate
// kernels with no atomics, so every sum is taken in one fixed order.
//
// Design. One CTA of 4 warps per (bh, 64-row q tile); each warp owns 16 q
// rows, and its S, dP and dQ tiles stay in registers in the fragment layout
// of flash_common.cuh. Q and dO stay in shared memory for the whole loop;
// each key tile is loaded row-major (the B operand of Q K^T, and V for
// dO V^T) and K once more transposed (the B operand of dS K), as the forward
// holds V. Keys and rows past S are masked (P = 0 past S; zero-filled rows),
// so S need not be a multiple of 64 (the eval geometries give 1672, 6688).
//
// What bounds it on the H100. Per (bh) it does three products of 2*S^2*d
// FLOPs (Q K^T, dO V^T, dS K) and S^2 exp2; with K5's 8*S^2*d the backward
// has the forward's balance of tensor-core work to exp2 twice over, so at
// d=64 989 TFLOP/s and the special-function units bound it about equally;
// bytes (q, k, v, dO, dQ, lse, delta once) are far below both. This first
// version uses mma.sync (not wgmma) and no cp.async/TMA pipelining; the
// measured times are in PERF.md.
//
// float32 inputs run the same fragment ownership with scalar FMAs
// (flash_common.cuh), for checking, not speed.

#include "flash_common.cuh"

namespace {

template <typename T, int D>
struct DqCfg {
  static constexpr int BN = 64;         // keys per tile
  static constexpr int SQ = D + PAD;    // row stride of sQ, sdO, sK, sV
  static constexpr int SKT = BN + PAD;  // row stride of sKt ([D][BN])
  static constexpr int SP = BN + 4;     // row stride of the f32 dS tile
  static constexpr size_t row_elems = size_t(BLOCK_M) * SQ;
  static constexpr size_t key_elems = size_t(BN) * SQ;
  static constexpr size_t kt_elems = size_t(D) * SKT;
  static constexpr size_t p_floats =
      std::is_same<T, float>::value ? size_t(NWARPS) * 16 * SP : 0;
  static constexpr size_t smem_bytes =
      (2 * row_elems + 2 * key_elems + kt_elems) * sizeof(T) +
      p_floats * sizeof(float);
  static_assert(D % 16 == 0, "head dim");
  static_assert((SQ * sizeof(T)) % 16 == 0, "16-byte rows");
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int S,
                    float scale2, float scale) {
  using C = DqCfg<T, D>;
  constexpr int NT_S = C::BN / 8;  // score n-tiles per warp
  constexpr int NT_D = D / 8;      // dQ n-tiles per warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + C::row_elems;
  T* sK = sdO + C::row_elems;
  T* sV = sK + C::key_elems;
  T* sKt = sV + C::key_elems;
  float* sP = reinterpret_cast<float*>(sKt + C::kt_elems);

  const int q0 = blockIdx.x * BLOCK_M;
  const int64_t base = int64_t(blockIdx.y) * S * D;
  const int64_t row_base = int64_t(blockIdx.y) * S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int wrow = warp * 16;  // first q row of this warp in the tile

  load_rows<T, D, C::SQ>(sQ, q + base + int64_t(q0) * D, D, BLOCK_M, S - q0);
  load_rows<T, D, C::SQ>(sdO, dout + base + int64_t(q0) * D, D, BLOCK_M,
                         S - q0);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + r * 8;
    row_lse[r] = row < S ? lse[row_base + row] : 0.f;
    row_delta[r] = row < S ? delta[row_base + row] : 0.f;
  }

  float acc[NT_D][4];
#pragma unroll
  for (int i = 0; i < NT_D; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int n_kt = (S + C::BN - 1) / C::BN;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * C::BN;
    const T* kt_src = k + base + int64_t(k0) * D;
    __syncthreads();  // previous tiles fully consumed
    load_rows<T, D, C::SQ>(sK, kt_src, D, C::BN, S - k0);
    load_rows<T, D, C::SQ>(sV, v + base + int64_t(k0) * D, D, C::BN, S - k0);
    load_transposed<T, D, C::SKT>(sKt, kt_src, D, C::BN, S - k0);
    __syncthreads();

    float s[NT_S][4], dp[NT_S][4];
#pragma unroll
    for (int i = 0; i < NT_S; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    warp_gemm_nt<T, D, NT_S, C::SQ, C::SQ>(s, sQ + wrow * C::SQ, sK);
    warp_gemm_nt<T, D, NT_S, C::SQ, C::SQ>(dp, sdO + wrow * C::SQ, sV);

    // ---- dS = P o (dP - delta), P = 0 on keys past S ----------------------
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + tig * 2 + (e & 1);
        const float p =
            col < S ? exp2f(s[nt][e] * scale2 - row_lse[e >> 1]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - row_delta[e >> 1]);
      }

    // ---- dQ += dS K --------------------------------------------------------
    warp_gemm_pv<T, C::BN, NT_D, C::SKT, C::SP>(acc, s, sKt,
                                                sP + warp * 16 * C::SP);
  }
  store_rows<T, NT_D, D>(dq + base, acc, q0 + wrow, S, scale);
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int s,
              float scale2, float scale, cudaStream_t stream) {
  const dim3 grid((s + BLOCK_M - 1) / BLOCK_M, bh);
  auto kernel = flash_bwd_dq_kernel<T, D>;
  return launch_kernel(
      kernel, grid, NTHREADS, DqCfg<T, D>::smem_bytes, stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), s, scale2, scale);
}

template <typename T>
int launch_dq_d(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dq, int bh, int s,
                int d, float scale2, float scale, cudaStream_t st) {
  if (d == 16)
    return launch_dq<T, 16>(q, k, v, dout, lse, delta, dq, bh, s, scale2,
                            scale, st);
  if (d == 32)
    return launch_dq<T, 32>(q, k, v, dout, lse, delta, dq, bh, s, scale2,
                            scale, st);
  if (d == 64)
    return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, bh, s, scale2,
                            scale, st);
  return kBadArgument;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, dout, dq: contiguous [bh, s, d]
// in dtype; lse, delta: contiguous [bh, s] f32. scale2 = d^-1/2 * log2(e),
// scale = d^-1/2. Returns the launch's cudaError_t (0 on success).
extern "C" int smtl_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int bh, int s,
                                 int d, int dtype, float scale2, float scale,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_dq_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, bh, s, d,
                                      scale2, scale, st);
  if (dtype == 0)
    return launch_dq_d<float>(q, k, v, dout, lse, delta, dq, bh, s, d, scale2,
                              scale, st);
  return kBadArgument;
}
