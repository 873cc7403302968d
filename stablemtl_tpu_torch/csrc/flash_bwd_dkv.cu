// K5: flash-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces stablemtl_tpu/ops/flash_attention.py::_fa_dkv_kernel. For each
// (bh, 64-key tile) it loops over 64-row q tiles and accumulates
//   dV += P^T dO,   dK += dS^T Q,   then scales dK by d^-1/2,
// with P = exp2(S * d^-1/2 * log2(e) - lse) (no clamp, as JAX) and
// dS = P o (dP - delta), recomputed from Q, K, V, dO and the per-row lse and
// delta = rowsum(dO o O). Its partner K4 (flash_bwd_dq.cu) computes dQ in a
// q-parallel grid; as in JAX the two are separate kernels with no atomics,
// so every sum is taken in one fixed order.
//
// Design. One CTA of 4 warps per (bh, 64-key tile); each warp owns 16 keys
// and works in the TRANSPOSED frame, S^T = K Q^T and dP^T = V dO^T
// (mma.sync m16n8k16, K and V row-major as the A operand, Q and dO
// row-major as the B operand). Then P^T and dS^T are already A fragments in
// registers, rounded to the input dtype, and feed dV += P^T dO and
// dK += dS^T Q straight from registers, against Q and dO held once more
// transposed in shared memory. The dK and dV accumulators take 2*16*d f32
// per warp (64 registers a thread at d=64). Keys and rows past S are masked
// (P = 0 on q rows past S; zero-filled tiles; no store past S).
//
// What bounds it on the H100. Per (bh) it does four products of 2*S^2*d
// FLOPs (K Q^T, V dO^T, P^T dO, dS^T Q) and S^2 exp2 (see flash_bwd_dq.cu
// for the balance with K4); bytes are far below both. This first version
// uses mma.sync (not wgmma) and no cp.async/TMA pipelining; the measured
// times are in PERF.md.
//
// float32 inputs run the same fragment ownership with scalar FMAs
// (flash_common.cuh), for checking, not speed.

#include "flash_common.cuh"

namespace {

template <typename T, int D>
struct DkvCfg {
  static constexpr int BQ = 64;         // q rows per tile
  static constexpr int SQ = D + PAD;    // row stride of sK, sV, sQ, sdO
  static constexpr int SQT = BQ + PAD;  // row stride of sQt, sdOt ([D][BQ])
  static constexpr int SP = BQ + 4;     // row stride of the f32 P^T tile
  static constexpr size_t row_elems = size_t(BLOCK_M) * SQ;  // 64 keys
  static constexpr size_t q_elems = size_t(BQ) * SQ;
  static constexpr size_t qt_elems = size_t(D) * SQT;
  static constexpr size_t p_floats =
      std::is_same<T, float>::value ? size_t(NWARPS) * 16 * SP : 0;
  static constexpr size_t smem_bytes =
      (2 * row_elems + 2 * q_elems + 2 * qt_elems) * sizeof(T) +
      (2 * BQ + p_floats) * sizeof(float);
  static_assert(D % 16 == 0, "head dim");
  static_assert((SQ * sizeof(T)) % 16 == 0, "16-byte rows");
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, float scale2, float scale) {
  using C = DkvCfg<T, D>;
  constexpr int NT_Q = C::BQ / 8;  // score n-tiles (q rows) per warp
  constexpr int NT_D = D / 8;      // dK/dV n-tiles per warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + C::row_elems;
  T* sQ = sV + C::row_elems;
  T* sdO = sQ + C::q_elems;
  T* sQt = sdO + C::q_elems;
  T* sdOt = sQt + C::qt_elems;
  float* sLse = reinterpret_cast<float*>(sdOt + C::qt_elems);
  float* sDelta = sLse + C::BQ;
  float* sP = sDelta + C::BQ;

  const int k0 = blockIdx.x * BLOCK_M;
  const int64_t base = int64_t(blockIdx.y) * S * D;
  const int64_t row_base = int64_t(blockIdx.y) * S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tig = lane & 3;
  const int wrow = warp * 16;  // first key of this warp in the tile

  load_rows<T, D, C::SQ>(sK, k + base + int64_t(k0) * D, D, BLOCK_M, S - k0);
  load_rows<T, D, C::SQ>(sV, v + base + int64_t(k0) * D, D, BLOCK_M, S - k0);

  float dk_acc[NT_D][4], dv_acc[NT_D][4];
#pragma unroll
  for (int i = 0; i < NT_D; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  const int n_qt = (S + C::BQ - 1) / C::BQ;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * C::BQ;
    const T* q_src = q + base + int64_t(q0) * D;
    const T* do_src = dout + base + int64_t(q0) * D;
    __syncthreads();  // previous tiles fully consumed
    load_rows<T, D, C::SQ>(sQ, q_src, D, C::BQ, S - q0);
    load_rows<T, D, C::SQ>(sdO, do_src, D, C::BQ, S - q0);
    load_transposed<T, D, C::SQT>(sQt, q_src, D, C::BQ, S - q0);
    load_transposed<T, D, C::SQT>(sdOt, do_src, D, C::BQ, S - q0);
    for (int i = threadIdx.x; i < C::BQ; i += NTHREADS) {
      const bool valid = q0 + i < S;
      sLse[i] = valid ? lse[row_base + q0 + i] : 0.f;
      sDelta[i] = valid ? delta[row_base + q0 + i] : 0.f;
    }
    __syncthreads();

    // ---- S^T = K Q^T, dP^T = V dO^T (rows: this warp's 16 keys) -----------
    float st[NT_Q][4], dpt[NT_Q][4];
#pragma unroll
    for (int i = 0; i < NT_Q; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
    warp_gemm_nt<T, D, NT_Q, C::SQ, C::SQ>(st, sK + wrow * C::SQ, sQ);
    warp_gemm_nt<T, D, NT_Q, C::SQ, C::SQ>(dpt, sV + wrow * C::SQ, sdO);

    // ---- P^T, dS^T = P^T o (dP^T - delta); P = 0 on q rows past S ---------
#pragma unroll
    for (int nt = 0; nt < NT_Q; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + tig * 2 + (e & 1);  // q row in the tile
        const float p =
            q0 + col < S ? exp2f(st[nt][e] * scale2 - sLse[col]) : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - sDelta[col]);
      }

    // ---- dV += P^T dO, dK += dS^T Q ----------------------------------------
    float* pw = sP + warp * 16 * C::SP;
    warp_gemm_pv<T, C::BQ, NT_D, C::SQT, C::SP>(dv_acc, st, sdOt, pw);
    warp_gemm_pv<T, C::BQ, NT_D, C::SQT, C::SP>(dk_acc, dpt, sQt, pw);
  }
  store_rows<T, NT_D, D>(dk + base, dk_acc, k0 + wrow, S, scale);
  store_rows<T, NT_D, D>(dv + base, dv_acc, k0 + wrow, S, 1.f);
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int s, float scale2, float scale, cudaStream_t stream) {
  const dim3 grid((s + BLOCK_M - 1) / BLOCK_M, bh);
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  return launch_kernel(
      kernel, grid, NTHREADS, DkvCfg<T, D>::smem_bytes, stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), s, scale2, scale);
}

template <typename T>
int launch_dkv_d(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int bh, int s, int d, float scale2,
                 float scale, cudaStream_t st) {
  if (d == 16)
    return launch_dkv<T, 16>(q, k, v, dout, lse, delta, dk, dv, bh, s,
                             scale2, scale, st);
  if (d == 32)
    return launch_dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, bh, s,
                             scale2, scale, st);
  if (d == 64)
    return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, bh, s,
                             scale2, scale, st);
  return kBadArgument;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, dout, dk, dv: contiguous
// [bh, s, d] in dtype; lse, delta: contiguous [bh, s] f32.
// scale2 = d^-1/2 * log2(e), scale = d^-1/2. Returns the launch's
// cudaError_t (0 on success).
extern "C" int smtl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int bh, int s, int d, int dtype,
                                  float scale2, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_dkv_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, bh,
                                       s, d, scale2, scale, st);
  if (dtype == 0)
    return launch_dkv_d<float>(q, k, v, dout, lse, delta, dk, dv, bh, s, d,
                               scale2, scale, st);
  return kBadArgument;
}
