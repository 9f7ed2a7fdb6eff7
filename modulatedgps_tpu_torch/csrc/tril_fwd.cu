// B[k, n, m'] = sum_{m >= m'} A[m, n] * L[k, m, m']: the forward of the
// conditional's q_sqrt term, B = A^T tril(L_k), from bf16 operands.  Two entry
// points share one kernel, templated on the output type:
//
//   mgp_tril_fwd      B16 = bf16(B)  (the diagonal variance, atl_sq_colsum)
//   mgp_tril_fwd_f32  B   in f32     (the full covariance, atl_matmul)
//
// Replaces modulatedgps_tpu/ops/pallas_tril.py:_k_fwd_b16 (_fwd_pallas_b16)
// and _k_fwd (_fwd_pallas).
//
// Bound on the H100: tensor-core math.  At M=4096, N=8192, K=8 the lower
// triangle alone is K*N*M^2/2 = 5.5e11 multiply-adds (1.1 TFLOP) against
// ~0.74 GB of compulsory traffic (A, tril L, B16), so it has to run on the
// bf16 tensor cores; SIMT fp32 would be 15x slower at peak.  Precision is
// the TPU's class: bf16 operands, fp32 accumulators held over the whole
// m-run, one rounding to the output type at the end; never bf16 accumulation
// or TF32.  The f32 output doubles B's store traffic (0.27 GB at N=2048, K=8),
// still small next to the multiply-adds (1.4e11 there).
// Design: one CUDA block per (m'-tile of BP, n-tile of BN, k).  The block
// walks the m-tiles from its diagonal tile down to M (the strictly-upper
// tiles of L are never read, which halves the dense work, as the TPU's
// lower-triangle block enumeration did).  Each step stages an A tile
// [BK m][BN n] and an L tile [BK m][BP m'] in shared memory; A is consumed
// transposed as col_major wmma fragments.  Elements with m < m' (the
// diagonal tiles' upper part) and everything past M or N are zeroed as they
// are staged, so garbage above the diagonal never enters the sum.  The next
// step's tiles are prefetched into registers while the tensor cores run.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include "tiles.cuh"

using namespace nvcuda;

namespace {

constexpr int BN = 128;        // n rows of the output tile
constexpr int BP = 128;        // m' columns of the output tile
constexpr int BK = 32;         // m depth per step
constexpr int NTHR = 256;      // 8 warps: 2 along n x 4 along m'
constexpr int LDA = BN + 8;    // shared row pitch (elements), keeps 32 B alignment
constexpr int LDB = BP + 8;
constexpr int WN = 64;         // warp tile along n
constexpr int WP = 32;         // warp tile along m'
constexpr int FN = WN / 16;
constexpr int FP = WP / 16;
constexpr int CHUNKS = BK * BN / 8 / NTHR;   // 16-byte chunks per thread per tile (2)

static_assert(BN == BP, "the A and L tiles share one chunk layout");

using mgp::Pack8;
using mgp::load_row8;

// Eight consecutive outputs from fp32 values, one rounding each; vec: the
// eight lie inside the row and the store is aligned.
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* v, int valid,
                                       bool vec) {
  Pack8 p;
#pragma unroll
  for (int q = 0; q < 8; ++q) p.s[q] = __bfloat16_as_ushort(__float2bfloat16_rn(v[q]));
  if (vec) {
    *reinterpret_cast<uint4*>(dst) = p.u;
  } else {
    unsigned short* d = reinterpret_cast<unsigned short*>(dst);
    for (int q = 0; q < valid; ++q) d[q] = p.s[q];
  }
}

__device__ __forceinline__ void store8(float* dst, const float* v, int valid, bool vec) {
  if (vec) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    for (int q = 0; q < valid; ++q) dst[q] = v[q];
  }
}

template <typename OutT>
__global__ void __launch_bounds__(NTHR)
tril_fwd_kernel(const __nv_bfloat16* __restrict__ A,
                const __nv_bfloat16* __restrict__ L,
                OutT* __restrict__ Bout, int M, int N) {
  __shared__ __align__(32) __nv_bfloat16 As[BK * LDA];
  __shared__ __align__(32) __nv_bfloat16 Ls[BK * LDB];
  __shared__ __align__(32) float stage[NTHR / 32][16 * 16];

  const int p0 = blockIdx.x * BP;
  const int n0 = blockIdx.y * BN;
  const int k = blockIdx.z;
  const __nv_bfloat16* Lk = L + (size_t)k * M * M;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wn = warp / (BP / WP);
  const int wp = warp % (BP / WP);
  const bool a_vec = (N % 8) == 0;
  const bool l_vec = (M % 8) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FN][FP];
#pragma unroll
  for (int i = 0; i < FN; ++i)
#pragma unroll
    for (int j = 0; j < FP; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  uint4 ra[CHUNKS], rl[CHUNKS];
  auto fetch = [&](int m0) {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int e = tid + c * NTHR;
      const int r = e / (BN / 8), c8 = (e % (BN / 8)) * 8;
      const int m = m0 + r;
      ra[c] = load_row8(A, m, M, n0 + c8, N, a_vec);
      Pack8 p;
      p.u = load_row8(Lk, m, M, p0 + c8, M, l_vec);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (m < p0 + c8 + q) p.s[q] = 0;   // strictly upper
      rl[c] = p.u;
    }
  };

  fetch(p0);
  for (int m0 = p0; m0 < M; m0 += BK) {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int e = tid + c * NTHR;
      const int r = e / (BN / 8), c8 = (e % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(&As[r * LDA + c8]) = ra[c];
      *reinterpret_cast<uint4*>(&Ls[r * LDB + c8]) = rl[c];
    }
    __syncthreads();
    if (m0 + BK < M) fetch(m0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[FN];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[FP];
#pragma unroll
      for (int i = 0; i < FN; ++i)
        wmma::load_matrix_sync(fa[i], &As[kk * LDA + wn * WN + i * 16], LDA);
#pragma unroll
      for (int j = 0; j < FP; ++j)
        wmma::load_matrix_sync(fb[j], &Ls[kk * LDB + wp * WP + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < FN; ++i)
#pragma unroll
        for (int j = 0; j < FP; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: each warp rounds its fp32 fragments to the output type once and
  // stores them row by row (B is [K, N, M], m' contiguous).
  float* st = stage[warp];
  const int r = lane / 2, c8 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < FN; ++i) {
#pragma unroll
    for (int j = 0; j < FP; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int n = n0 + wn * WN + i * 16 + r;
      const int mp = p0 + wp * WP + j * 16 + c8;
      if (n < N && mp < M)
        store8(Bout + ((size_t)k * N + n) * M + mp, &st[r * 16 + c8],
               M - mp < 8 ? M - mp : 8, l_vec && mp + 8 <= M);
      __syncwarp();
    }
  }
}

template <typename OutT>
int launch(const void* A, const void* L, void* B, int M, int N, int K, void* stream) {
  if (M > 0 && N > 0 && K > 0) {
    dim3 grid((M + BP - 1) / BP, (N + BN - 1) / BN, K);
    tril_fwd_kernel<OutT><<<grid, NTHR, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(L),
        static_cast<OutT*>(B), M, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A [M, N] bf16, L [K, M, M] bf16 (upper triangle ignored) -> B [K, N, M] bf16.
extern "C" int mgp_tril_fwd(const void* A, const void* L, void* B, int M, int N,
                            int K, void* stream) {
  return launch<__nv_bfloat16>(A, L, B, M, N, K, stream);
}

// The same contraction -> B [K, N, M] f32.
extern "C" int mgp_tril_fwd_f32(const void* A, const void* L, void* B, int M, int N,
                                int K, void* stream) {
  return launch<float>(A, L, B, M, N, K, stream);
}
