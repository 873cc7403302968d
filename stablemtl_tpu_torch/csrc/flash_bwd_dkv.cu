// K5: flash-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces stablemtl_tpu/ops/flash_attention.py::_fa_dkv_kernel. For each
// (bh, key tile) it loops over q tiles and accumulates
//   dV += P^T dO,   dK += dS^T Q,   then scales dK by d^-1/2,
// with P = exp2(S * d^-1/2 * log2(e) - lse) (no clamp, as JAX) and
// dS = P o (dP - delta), recomputed from Q, K, V, dO and the per-row lse and
// delta = rowsum(dO o O); P and dS are rounded to the input dtype before
// their products. Its partner K4 (flash_bwd_dq.cu) computes dQ in a
// q-parallel grid; as in JAX the two are separate kernels with no atomics,
// so every sum is taken in one fixed order.
//
// bf16 runs the Hopper template of flash_bwd_sm90.cuh (TMA ring, wgmma,
// warp-specialised consumers; its design and bound are written there) in
// its key-parallel form, in the transposed frame: k and v resident, q and
// dO streamed in 64-row tiles with their lse and delta, S^T = K Q^T and
// dP^T = V dO^T from shared memory, then dV += P^T dO and dK += dS^T Q
// with P^T and dS^T as register A operands and the streamed tiles read
// MN-major (no transposed copy). Three consumers (192-key CTAs: at the
// training shape 90 CTAs on 132 SMs, one wave); each holds 128 f32
// accumulator registers at d = 64 (S^T, dP^T, dK, dV) within its 160. What
// bounds it at the training shape [10, 1728, 64]: 8 * 1728^2 * 64 * 10 =
// 1.53e10 FLOPs, 0.0155 ms at 989 TFLOP/s, and 0.0077 ms of exp2.
//
// Planted fault (chip_smoke.py phase 2, on a copy patched on the card
// machine): a K5 that skips its last q tile failed all 36 bf16 dk and dv
// checks (relative L2 0.093-0.251).
//
// float32 inputs run the first version below: 4 warps per 64-key tile in
// the transposed frame, scalar f32 FMAs in the m16n8k16 fragment ownership
// of flash_common.cuh, Q and dO held once more transposed for the second
// products; for checking, not speed.

#include "flash_bwd_sm90.cuh"

namespace {

constexpr int DKV_CONSUMERS = 3;

template <int D>
struct DkvCfg {
  static constexpr int BQ = 64;         // q rows per tile
  static constexpr int SQ = D + PAD;    // row stride of sK, sV, sQ, sdO
  static constexpr int SQT = BQ + PAD;  // row stride of sQt, sdOt ([D][BQ])
  static constexpr int SP = BQ + 4;     // row stride of the P^T tile
  static constexpr size_t row_elems = size_t(BLOCK_M) * SQ;  // 64 keys
  static constexpr size_t q_elems = size_t(BQ) * SQ;
  static constexpr size_t qt_elems = size_t(D) * SQT;
  static constexpr size_t smem_bytes =
      (2 * row_elems + 2 * q_elems + 2 * qt_elems + 2 * BQ +
       NWARPS * 16 * SP) *
      sizeof(float);
  static_assert(D % 16 == 0, "head dim");
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int S, float scale2, float scale) {
  using C = DkvCfg<D>;
  constexpr int NT_Q = C::BQ / 8;  // score n-tiles (q rows) per warp
  constexpr int NT_D = D / 8;      // dK/dV n-tiles per warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + C::row_elems;
  float* sQ = sV + C::row_elems;
  float* sdO = sQ + C::q_elems;
  float* sQt = sdO + C::q_elems;
  float* sdOt = sQt + C::qt_elems;
  float* sLse = sdOt + C::qt_elems;
  float* sDelta = sLse + C::BQ;
  float* sP = sDelta + C::BQ;

  const int k0 = blockIdx.x * BLOCK_M;
  const int64_t base = int64_t(blockIdx.y) * S * D;
  const int64_t row_base = int64_t(blockIdx.y) * S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tig = lane & 3;
  const int wrow = warp * 16;  // first key of this warp in the tile

  load_rows<float, D, C::SQ>(sK, k + base + int64_t(k0) * D, D, BLOCK_M,
                             S - k0);
  load_rows<float, D, C::SQ>(sV, v + base + int64_t(k0) * D, D, BLOCK_M,
                             S - k0);

  float dk_acc[NT_D][4], dv_acc[NT_D][4];
#pragma unroll
  for (int i = 0; i < NT_D; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  const int n_qt = (S + C::BQ - 1) / C::BQ;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * C::BQ;
    const float* q_src = q + base + int64_t(q0) * D;
    const float* do_src = dout + base + int64_t(q0) * D;
    __syncthreads();  // previous tiles fully consumed
    load_rows<float, D, C::SQ>(sQ, q_src, D, C::BQ, S - q0);
    load_rows<float, D, C::SQ>(sdO, do_src, D, C::BQ, S - q0);
    load_transposed<float, D, C::SQT>(sQt, q_src, D, C::BQ, S - q0);
    load_transposed<float, D, C::SQT>(sdOt, do_src, D, C::BQ, S - q0);
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
    warp_gemm_nt<D, NT_Q, C::SQ, C::SQ>(st, sK + wrow * C::SQ, sQ);
    warp_gemm_nt<D, NT_Q, C::SQ, C::SQ>(dpt, sV + wrow * C::SQ, sdO);

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
    warp_gemm_pv<C::BQ, NT_D, C::SQT, C::SP>(dv_acc, st, sdOt, pw);
    warp_gemm_pv<C::BQ, NT_D, C::SQT, C::SP>(dk_acc, dpt, sQt, pw);
  }
  store_rows<NT_D, D>(dk + base, dk_acc, k0 + wrow, S, scale);
  store_rows<NT_D, D>(dv + base, dv_acc, k0 + wrow, S, 1.f);
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int s, int dtype, float scale2, float scale,
               cudaStream_t stream) {
  if (dtype == 1)
    return launch_bwd_sm90<D, DKV_CONSUMERS, true>(
        q, k, v, dout, lse, delta, dk, dv, bh, s, scale2, scale, stream);
  const dim3 grid((s + BLOCK_M - 1) / BLOCK_M, bh);
  return launch_kernel(
      flash_bwd_dkv_f32<D>, grid, NTHREADS, DkvCfg<D>::smem_bytes, stream,
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), s, scale2, scale);
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
  if (dtype != 0 && dtype != 1) return kBadArgument;
  if (d == 16)
    return launch_dkv<16>(q, k, v, dout, lse, delta, dk, dv, bh, s, dtype,
                          scale2, scale, st);
  if (d == 32)
    return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, bh, s, dtype,
                          scale2, scale, st);
  if (d == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, s, dtype,
                          scale2, scale, st);
  return kBadArgument;
}
