// Backward of B = A^T tril L_k, the conditional's q_sqrt term:
//
//   dL[k, m, m'] = sum_n A16[m, n] W_k[n, m']          (m >= m', else 0)
//   dA[m, n]     = sum_k sum_{m' <= m} L16[k, m, m'] W_k[n, m']
//
// with W read in one of two ways (the kernels are templated on it):
//
//   scaled: the square-sum extra[k, n] = sum_m' B16[k, n, m']^2 with
//     B16 = bf16(B), whose cotangent scaling is fused into the staging,
//     W_k[n, m'] = bf16( f32(B16[k, n, m']) * G[k, n] ),  G = 2 * dextra;
//     replaces modulatedgps_tpu/ops/pallas_tril.py:_k_dl_g (_dl_pallas_g)
//     and _k_da_g (_da_pallas_g);
//   direct: W16 = bf16(dB), the cotangent of the f32 B of the joint
//     covariance, read from memory; replaces pallas_tril.py:_k_dl
//     (_dl_pallas) and _k_da (_da_pallas), atl_matmul's backward.
//
// Bound on the H100: tensor-core math.  At M=4096, N=8192, K=8 each kernel
// does the lower triangle's K*N*M^2/2 = 5.5e11 multiply-adds against ~1 GB
// of compulsory traffic, so both run bf16 wmma fragments with fp32
// accumulators held over the whole contraction (the TPU's precision class:
// bf16 operands, f32 accumulation; never bf16 accumulation or TF32).  W is
// formed in the rounding order of the TPU kernels (f32 product, one bf16
// rounding) while each B16 tile is staged into shared memory, so no W array
// ever reaches device memory (the direct form stages W16 as read).  Loads
// of the next step's tiles are started into registers before the current
// step's MMAs; the scaling and masking happen when the registers are stored
// to shared memory, so they never wait on a load in flight.
//
// tril_dl: one block per (m-tile, m'-tile, k), contracting over all N.  A
//   block above the diagonal (m-tile < m'-tile) writes its tile as zeros and
//   leaves; a diagonal block writes zeros above the diagonal, so dL comes
//   out exactly lower-triangular and no `tril` pass is needed afterwards.
// tril_da: one block per (m-tile, n-tile), walking k and, for each k, the
//   m'-tiles up to its diagonal; L's strictly-upper entries are zeroed as
//   they are staged, so only its lower triangle is read into the sum.
//   Blocks with the longest runs (bottom m-tiles) are scheduled first.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include "tiles.cuh"

using namespace nvcuda;
using mgp::Pack8;
using mgp::load_row8;

namespace {

constexpr int BT = 128;        // output tile edge
constexpr int BK = 32;         // contraction depth per step
constexpr int NTHR = 256;      // 8 warps: 2 along the rows x 4 along the columns
constexpr int WR = 64;         // warp tile rows
constexpr int WC = 32;         // warp tile columns
constexpr int FR = WR / 16;
constexpr int FC = WC / 16;
constexpr int LDT = BK + 8;    // pitch of a [BT][BK] tile (32-byte aligned rows)
constexpr int LDW = BT + 8;    // pitch of a [BK][BT] tile
constexpr int CH = BT * BK / 8 / NTHR;   // 16-byte chunks per thread per tile (2)

static_assert(BT / WR * (BT / WC) == NTHR / 32, "warp grid covers the tile");

// bf16(f32(b) * g) for eight bf16 values: the TPU kernels' rounding order.
__device__ __forceinline__ uint4 scale8(uint4 raw, float g) {
  Pack8 p;
  p.u = raw;
#pragma unroll
  for (int q = 0; q < 8; ++q)
    p.s[q] = __bfloat16_as_ushort(__float2bfloat16_rn(
        __bfloat162float(__ushort_as_bfloat16(p.s[q])) * g));
  return p.u;
}

// The staged W: B16 scaled by g (kScaled), or W16 as read.
template <bool kScaled>
__device__ __forceinline__ uint4 w8(uint4 raw, float g) {
  if constexpr (kScaled) return scale8(raw, g);
  return raw;
}

template <bool kScaled>
__global__ void __launch_bounds__(NTHR)
tril_dl_kernel(const __nv_bfloat16* __restrict__ A,
               const __nv_bfloat16* __restrict__ B,
               const float* __restrict__ G, float* __restrict__ dL, int M, int N) {
  __shared__ __align__(32) __nv_bfloat16 As[BT * LDT];   // [m][n]
  __shared__ __align__(32) __nv_bfloat16 Ws[BK * LDW];   // [n][m']
  __shared__ __align__(32) float stage[NTHR / 32][16 * 16];

  const int p0 = blockIdx.x * BT;
  const int m0 = blockIdx.y * BT;
  const int k = blockIdx.z;
  float* out = dL + (size_t)k * M * M;
  if (m0 < p0) {
    mgp::zero_tile(out, M, M, M, m0, p0, BT);
    return;
  }
  const __nv_bfloat16* Bk = B + (size_t)k * N * M;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wr = warp / (BT / WC);
  const int wc = warp % (BT / WC);
  const bool a_vec = (N % 8) == 0;
  const bool b_vec = (M % 8) == 0;

  mgp::Acc acc[FR][FC];
#pragma unroll
  for (int i = 0; i < FR; ++i)
#pragma unroll
    for (int j = 0; j < FC; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  uint4 ra[CH], rw[CH];
  float rg[CH] = {};
  auto fetch = [&](int n0) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int e = tid + c * NTHR;
      ra[c] = load_row8(A, m0 + e / (BK / 8), M, n0 + (e % (BK / 8)) * 8, N, a_vec);
      const int n = n0 + e / (BT / 8);
      rw[c] = load_row8(Bk, n, N, p0 + (e % (BT / 8)) * 8, M, b_vec);
      if constexpr (kScaled) rg[c] = n < N ? G[(size_t)k * N + n] : 0.f;
    }
  };

  fetch(0);
  for (int n0 = 0; n0 < N; n0 += BK) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int e = tid + c * NTHR;
      *reinterpret_cast<uint4*>(&As[(e / (BK / 8)) * LDT + (e % (BK / 8)) * 8]) = ra[c];
      *reinterpret_cast<uint4*>(&Ws[(e / (BT / 8)) * LDW + (e % (BT / 8)) * 8]) =
          w8<kScaled>(rw[c], rg[c]);
    }
    __syncthreads();
    if (n0 + BK < N) fetch(n0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[FC];
#pragma unroll
      for (int j = 0; j < FC; ++j)
        wmma::load_matrix_sync(fb[j], &Ws[kk * LDW + wc * WC + j * 16], LDW);
#pragma unroll
      for (int i = 0; i < FR; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, &As[(wr * WR + i * 16) * LDT + kk], LDT);
#pragma unroll
        for (int j = 0; j < FC; ++j) wmma::mma_sync(acc[i][j], fa, fb[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  mgp::store_acc(acc, stage[warp], out, M, M, M, m0 + wr * WR, p0 + wc * WC,
                 true, lane);
}

template <bool kScaled>
__global__ void __launch_bounds__(NTHR)
tril_da_kernel(const __nv_bfloat16* __restrict__ L,
               const __nv_bfloat16* __restrict__ B,
               const float* __restrict__ G, float* __restrict__ dA, int M, int N,
               int K) {
  __shared__ __align__(32) __nv_bfloat16 Ls[BT * LDT];   // [m][m']
  __shared__ __align__(32) __nv_bfloat16 Ws[BT * LDT];   // [n][m']
  __shared__ __align__(32) float stage[NTHR / 32][16 * 16];

  const int n0 = blockIdx.x * BT;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BT;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wr = warp / (BT / WC);
  const int wc = warp % (BT / WC);
  const bool vec = (M % 8) == 0;
  // The m'-run of one k: tiles up to and including the diagonal.
  const int per_k = (min(m0 + BT, M) + BK - 1) / BK;
  const int steps = K * per_k;

  mgp::Acc acc[FR][FC];
#pragma unroll
  for (int i = 0; i < FR; ++i)
#pragma unroll
    for (int j = 0; j < FC; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  uint4 rl[CH], rw[CH];
  float rg[CH] = {};
  auto fetch = [&](int s) {
    const int k = s / per_k, p0 = (s % per_k) * BK;
    const __nv_bfloat16* Lk = L + (size_t)k * M * M;
    const __nv_bfloat16* Bk = B + (size_t)k * N * M;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int e = tid + c * NTHR;
      const int r = e / (BK / 8), c8 = (e % (BK / 8)) * 8;
      rl[c] = load_row8(Lk, m0 + r, M, p0 + c8, M, vec);
      rw[c] = load_row8(Bk, n0 + r, N, p0 + c8, M, vec);
      if constexpr (kScaled) rg[c] = n0 + r < N ? G[(size_t)k * N + n0 + r] : 0.f;
    }
  };

  fetch(0);
  for (int s = 0; s < steps; ++s) {
    const int p0 = (s % per_k) * BK;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int e = tid + c * NTHR;
      const int r = e / (BK / 8), c8 = (e % (BK / 8)) * 8;
      Pack8 p;
      p.u = rl[c];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (m0 + r < p0 + c8 + q) p.s[q] = 0;   // strictly upper
      *reinterpret_cast<uint4*>(&Ls[r * LDT + c8]) = p.u;
      *reinterpret_cast<uint4*>(&Ws[r * LDT + c8]) = w8<kScaled>(rw[c], rg[c]);
    }
    __syncthreads();
    if (s + 1 < steps) fetch(s + 1);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // W^T as matrix_b: element (m', n) sits at Ws[n * LDT + m'].
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[FC];
#pragma unroll
      for (int j = 0; j < FC; ++j)
        wmma::load_matrix_sync(fb[j], &Ws[(wc * WC + j * 16) * LDT + kk], LDT);
#pragma unroll
      for (int i = 0; i < FR; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, &Ls[(wr * WR + i * 16) * LDT + kk], LDT);
#pragma unroll
        for (int j = 0; j < FC; ++j) wmma::mma_sync(acc[i][j], fa, fb[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  mgp::store_acc(acc, stage[warp], dA, N, M, N, m0 + wr * WR, n0 + wc * WC,
                 false, lane);
}

template <bool kScaled>
int launch_dl(const void* A, const void* B, const void* G, void* dL, int M,
              int N, int K, void* stream) {
  if (M > 0 && N > 0 && K > 0) {
    const int nt = (M + BT - 1) / BT;
    dim3 grid(nt, nt, K);
    tril_dl_kernel<kScaled><<<grid, NTHR, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(B),
        static_cast<const float*>(G), static_cast<float*>(dL), M, N);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kScaled>
int launch_da(const void* L, const void* B, const void* G, void* dA, int M,
              int N, int K, void* stream) {
  if (M > 0 && N > 0 && K > 0) {
    dim3 grid((N + BT - 1) / BT, (M + BT - 1) / BT);
    tril_da_kernel<kScaled><<<grid, NTHR, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(L), static_cast<const __nv_bfloat16*>(B),
        static_cast<const float*>(G), static_cast<float*>(dA), M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A16 [M, N] bf16, B16 [K, N, M] bf16, G [K, N] f32 -> dL [K, M, M] f32,
// exactly lower-triangular.
extern "C" int mgp_tril_dl(const void* A, const void* B, const void* G, void* dL,
                           int M, int N, int K, void* stream) {
  return launch_dl<true>(A, B, G, dL, M, N, K, stream);
}

// L16 [K, M, M] bf16 (upper triangle ignored), B16 [K, N, M] bf16,
// G [K, N] f32 -> dA [M, N] f32.
extern "C" int mgp_tril_da(const void* L, const void* B, const void* G, void* dA,
                           int M, int N, int K, void* stream) {
  return launch_da<true>(L, B, G, dA, M, N, K, stream);
}

// A16 [M, N] bf16, W16 [K, N, M] bf16 -> dL [K, M, M] f32, exactly
// lower-triangular.
extern "C" int mgp_tril_dl_w(const void* A, const void* W, void* dL, int M,
                             int N, int K, void* stream) {
  return launch_dl<false>(A, W, nullptr, dL, M, N, K, stream);
}

// L16 [K, M, M] bf16 (upper triangle ignored), W16 [K, N, M] bf16 -> dA [M, N]
// f32.
extern "C" int mgp_tril_da_w(const void* L, const void* W, void* dA, int M,
                             int N, int K, void* stream) {
  return launch_da<false>(L, W, nullptr, dA, M, N, K, stream);
}
