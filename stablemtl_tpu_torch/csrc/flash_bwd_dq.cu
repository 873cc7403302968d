// K4: flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces stablemtl_tpu/ops/flash_attention.py::_fa_dq_kernel:
//   S  = Q K^T, dP = dO V^T
//   P  = exp2(S * d^-1/2 * log2(e) - lse)   (lse: the forward's base-2
//                                            logsumexp; no clamp, as JAX)
//   dS = P o (dP - delta)                   (delta = rowsum(dO o O), f32)
//   dQ = d^-1/2 sum_keys dS K               (dS rounded to the input dtype)
// Its partner K5 (flash_bwd_dkv.cu) computes dK and dV in a key-parallel
// grid; as in JAX the two are separate kernels with no atomics, so every
// sum is taken in one fixed order.
//
// bf16 runs the Hopper template of flash_bwd_sm90.cuh (TMA ring, wgmma,
// warp-specialised consumers; its design and bound are written there) in
// its q-parallel form: q and dO resident, k and v streamed in 64-key
// tiles, three consumers (192-row CTAs: at the training shape
// [10, 1728, 64] 90 CTAs on 132 SMs, one wave; each consumer holds 96 f32
// accumulator registers, S, dP and dQ, within the 160 that three
// consumers get). What bounds it there: 6 * 1728^2 * 64 * 10 = 1.15e10
// FLOPs, 0.0116 ms at 989 TFLOP/s, and 0.0077 ms of exp2.
//
// Planted fault (chip_smoke.py phase 2, on a copy patched on the card
// machine): a K4 that drops the ragged key tail (n_t = S / 64) failed all
// 12 bf16 dq checks whose S has one (1100, 1700; relative L2 0.105-0.155);
// at S = 1024, 1728 and 4096 (whole tiles) it cannot show.
//
// float32 inputs run the first version below: 4 warps per 64-row q tile,
// scalar f32 FMAs in the m16n8k16 fragment ownership of flash_common.cuh,
// K loaded once more transposed for dS K; for checking, not speed.

#include "flash_bwd_sm90.cuh"

namespace {

constexpr int DQ_CONSUMERS = 3;

template <int D>
struct DqCfg {
  static constexpr int BN = 64;         // keys per tile
  static constexpr int SQ = D + PAD;    // row stride of sQ, sdO, sK, sV
  static constexpr int SKT = BN + PAD;  // row stride of sKt ([D][BN])
  static constexpr int SP = BN + 4;     // row stride of the dS tile
  static constexpr size_t row_elems = size_t(BLOCK_M) * SQ;
  static constexpr size_t key_elems = size_t(BN) * SQ;
  static constexpr size_t kt_elems = size_t(D) * SKT;
  static constexpr size_t smem_bytes =
      (2 * row_elems + 2 * key_elems + kt_elems + NWARPS * 16 * SP) *
      sizeof(float);
  static_assert(D % 16 == 0, "head dim");
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int S, float scale2, float scale) {
  using C = DqCfg<D>;
  constexpr int NT_S = C::BN / 8;  // score n-tiles per warp
  constexpr int NT_D = D / 8;      // dQ n-tiles per warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sdO = sQ + C::row_elems;
  float* sK = sdO + C::row_elems;
  float* sV = sK + C::key_elems;
  float* sKt = sV + C::key_elems;
  float* sP = sKt + C::kt_elems;

  const int q0 = blockIdx.x * BLOCK_M;
  const int64_t base = int64_t(blockIdx.y) * S * D;
  const int64_t row_base = int64_t(blockIdx.y) * S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int wrow = warp * 16;  // first q row of this warp in the tile

  load_rows<float, D, C::SQ>(sQ, q + base + int64_t(q0) * D, D, BLOCK_M,
                             S - q0);
  load_rows<float, D, C::SQ>(sdO, dout + base + int64_t(q0) * D, D, BLOCK_M,
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
    const float* kt_src = k + base + int64_t(k0) * D;
    __syncthreads();  // previous tiles fully consumed
    load_rows<float, D, C::SQ>(sK, kt_src, D, C::BN, S - k0);
    load_rows<float, D, C::SQ>(sV, v + base + int64_t(k0) * D, D, C::BN,
                               S - k0);
    load_transposed<float, D, C::SKT>(sKt, kt_src, D, C::BN, S - k0);
    __syncthreads();

    float s[NT_S][4], dp[NT_S][4];
#pragma unroll
    for (int i = 0; i < NT_S; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    warp_gemm_nt<D, NT_S, C::SQ, C::SQ>(s, sQ + wrow * C::SQ, sK);
    warp_gemm_nt<D, NT_S, C::SQ, C::SQ>(dp, sdO + wrow * C::SQ, sV);

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
    warp_gemm_pv<C::BN, NT_D, C::SKT, C::SP>(acc, s, sKt,
                                             sP + warp * 16 * C::SP);
  }
  store_rows<NT_D, D>(dq + base, acc, q0 + wrow, S, scale);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int s,
              int dtype, float scale2, float scale, cudaStream_t stream) {
  if (dtype == 1)
    return launch_bwd_sm90<D, DQ_CONSUMERS, false>(
        q, k, v, dout, lse, delta, dq, nullptr, bh, s, scale2, scale,
        stream);
  const dim3 grid((s + BLOCK_M - 1) / BLOCK_M, bh);
  return launch_kernel(
      flash_bwd_dq_f32<D>, grid, NTHREADS, DqCfg<D>::smem_bytes, stream,
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), s, scale2, scale);
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
  if (dtype != 0 && dtype != 1) return kBadArgument;
  if (d == 16)
    return launch_dq<16>(q, k, v, dout, lse, delta, dq, bh, s, dtype, scale2,
                         scale, st);
  if (d == 32)
    return launch_dq<32>(q, k, v, dout, lse, delta, dq, bh, s, dtype, scale2,
                         scale, st);
  if (d == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, bh, s, dtype, scale2,
                         scale, st);
  return kBadArgument;
}
