// extra[k, n] = sum_p (sum_{m >= p} S[k, m, p] A[m, n])^2: the served
// variance's q_sqrt term |tril(S_k)^T a_n|^2 from bf16 operands, with the
// square and the column sum fused into the epilogue, so the [K, N, M]
// product never reaches device memory.
//
// Replaces modulatedgps_tpu/ops/pallas_quad.py:_quad_kernel (_quad_pallas),
// which kept S_k resident in VMEM across the n sweep (hence its M <= 2048
// limit, which does not carry over).
//
// Bound on the H100: tensor-core math.  At the served shape (K=8, M=4096,
// N=8192) the lower triangle is K*N*M(M+1)/2 = 5.5e11 multiply-adds against
// ~0.34 GB of compulsory traffic (S16, A16, the [K, N] output).  Precision
// is the TPU's class for this term (an f32 einsum at DEFAULT precision, one
// bf16 pass): bf16 operands, fp32 accumulators held over each whole m-run,
// the square and the sums in fp32; never bf16 accumulation or TF32.
// Design: one CUDA block per (n-tile of BN, k), n-tiles of one k adjacent
// in launch order, so the blocks in flight share S_k (32 MB in bf16 at
// M=4096, which fits the 50 MB L2: the Hopper analogue of the resident
// S_k).  The block walks the p-tiles; for each it walks the m-tiles from
// the diagonal tile down, as tril_fwd.cu does: bf16 wmma fragments with
// fp32 accumulators, S's entries with m < p (above its diagonal, NaN
// included) zeroed as they are staged, the next step's tiles prefetched
// into registers while the tensor cores run.  After each p-tile the warps
// square their fp32 fragments and add the row sums into registers, in a
// fixed order; the four warps along p are combined in shared memory, in a
// fixed order, and the output is written once.  No atomics: two runs give
// the same bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include "tiles.cuh"

using namespace nvcuda;

namespace {

constexpr int BN = 128;        // n rows of a block
constexpr int BP = 128;        // p columns of a p-tile
constexpr int BK = 32;         // m depth per step
constexpr int NTHR = 256;      // 8 warps: 2 along n x 4 along p
constexpr int LDA = BN + 8;    // shared row pitch (elements), keeps 32 B alignment
constexpr int LDB = BP + 8;
constexpr int WN = 64;         // warp tile along n
constexpr int WP = 32;         // warp tile along p
constexpr int FN = WN / 16;
constexpr int FP = WP / 16;
constexpr int NWP = BP / WP;   // warps along p (4)
constexpr int CHUNKS = BK * BN / 8 / NTHR;   // 16-byte chunks per thread per tile (2)

static_assert(BN == BP, "the A and S tiles share one chunk layout");

using mgp::Pack8;
using mgp::load_row8;

__global__ void __launch_bounds__(NTHR)
quad_kernel(const __nv_bfloat16* __restrict__ S, const __nv_bfloat16* __restrict__ A,
            float* __restrict__ out, int M, int N) {
  __shared__ __align__(32) __nv_bfloat16 As[BK * LDA];
  __shared__ __align__(32) __nv_bfloat16 Ss[BK * LDB];
  __shared__ __align__(32) float stage[NTHR / 32][16 * 16];
  __shared__ float part[NWP][BN];

  const int n0 = blockIdx.x * BN;
  const int k = blockIdx.y;
  const __nv_bfloat16* Sk = S + (size_t)k * M * M;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wn = warp / NWP;
  const int wp = warp % NWP;
  const bool a_vec = (N % 8) == 0;
  const bool s_vec = (M % 8) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FN][FP];
#pragma unroll
  for (int i = 0; i < FN; ++i)
#pragma unroll
    for (int j = 0; j < FP; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  float rowsum[FN];            // row wn*WN + i*16 + lane/2 of this warp
#pragma unroll
  for (int i = 0; i < FN; ++i) rowsum[i] = 0.f;

  uint4 ra[CHUNKS], rs[CHUNKS];
  auto fetch = [&](int p0, int m0) {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int e = tid + c * NTHR;
      const int r = e / (BN / 8), c8 = (e % (BN / 8)) * 8;
      const int m = m0 + r;
      ra[c] = load_row8(A, m, M, n0 + c8, N, a_vec);
      Pack8 p;
      p.u = load_row8(Sk, m, M, p0 + c8, M, s_vec);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (m < p0 + c8 + q) p.s[q] = 0;   // above S's diagonal
      rs[c] = p.u;
    }
  };

  // The (p-tile, m-step) pairs in order, one pipeline across p-tiles.
  int p0 = 0, m0 = 0;
  fetch(p0, m0);
  while (p0 < M) {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int e = tid + c * NTHR;
      const int r = e / (BN / 8), c8 = (e % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(&As[r * LDA + c8]) = ra[c];
      *reinterpret_cast<uint4*>(&Ss[r * LDB + c8]) = rs[c];
    }
    __syncthreads();
    int np0 = p0, nm0 = m0 + BK;
    if (nm0 >= M) {
      np0 = p0 + BP;
      nm0 = np0;
    }
    if (np0 < M) fetch(np0, nm0);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[FN];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[FP];
#pragma unroll
      for (int i = 0; i < FN; ++i)
        wmma::load_matrix_sync(fa[i], &As[kk * LDA + wn * WN + i * 16], LDA);
#pragma unroll
      for (int j = 0; j < FP; ++j)
        wmma::load_matrix_sync(fb[j], &Ss[kk * LDB + wp * WP + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < FN; ++i)
#pragma unroll
        for (int j = 0; j < FP; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
    if (np0 != p0) {
      // Epilogue of the p-tile: square the fp32 fragments, add each row's
      // 16-column sums into rowsum in a fixed order, restart the fragments.
      float* st = stage[warp];
      const int r = lane / 2, c8 = (lane % 2) * 8;
#pragma unroll
      for (int i = 0; i < FN; ++i) {
#pragma unroll
        for (int j = 0; j < FP; ++j) {
          wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
          __syncwarp();
          float v = 0.f;
#pragma unroll
          for (int q = 0; q < 8; ++q) v = fmaf(st[r * 16 + c8 + q], st[r * 16 + c8 + q], v);
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          rowsum[i] += v;
          __syncwarp();
          wmma::fill_fragment(acc[i][j], 0.0f);
        }
      }
    }
    p0 = np0;
    m0 = nm0;
  }

  if (lane % 2 == 0) {
#pragma unroll
    for (int i = 0; i < FN; ++i) part[wp][wn * WN + i * 16 + lane / 2] = rowsum[i];
  }
  __syncthreads();
  if (tid < BN && n0 + tid < N) {
    float v = part[0][tid];
#pragma unroll
    for (int w = 1; w < NWP; ++w) v += part[w][tid];
    out[(size_t)k * N + n0 + tid] = v;
  }
}

}  // namespace

// S [K, M, M] bf16 (upper triangle ignored), A [M, N] bf16 -> out [K, N] f32.
extern "C" int mgp_qsqrt_sq_colsum(const void* S, const void* A, void* out, int M,
                                   int N, int K, void* stream) {
  if (M > 0 && N > 0 && K > 0) {
    dim3 grid((N + BN - 1) / BN, K);
    quad_kernel<<<grid, NTHR, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(S), static_cast<const __nv_bfloat16*>(A),
        static_cast<float*>(out), M, N);
  }
  return static_cast<int>(cudaGetLastError());
}
