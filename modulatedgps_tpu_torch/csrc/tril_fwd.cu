// B[k, n, m'] = sum_{m >= m'} A[m, n] * L[k, m, m']: the forward of the
// conditional's q_sqrt term, B = A^T tril(L_k), from bf16 operands.  Two entry
// points share one kernel, templated on the output type:
//
//   mgp_tril_fwd      B16 = bf16(B)  (the diagonal variance, atl_sq_colsum)
//   mgp_tril_fwd_f32  B   in f32     (the full covariance, atl_matmul)
//
// and a third runs the same product as a 3-pass bf16 split of fp32 operands
// (tril_product.cuh's NPASS = 3: A_hi L_hi + A_lo L_hi + A_hi L_lo in one
// fp32 accumulator):
//
//   mgp_tril_fwd_split  B in f32 and extra[k, n] = sum_m' B^2 from the fp32
//                       accumulators (atl_sq_colsum with split: the SMGP's
//                       layers)
//
// Replaces modulatedgps_tpu/ops/pallas_tril.py:_k_fwd_b16 (_fwd_pallas_b16)
// and _k_fwd (_fwd_pallas).  The split's precision class is the JAX
// package's for its Cholesky pullback (pallas_trimm._dot3): at tau = 1e-2
// the mixture weights are one-hot to f32 rounding, and one bf16 pass in a
// layer's variance decides near-ties between experts.  It does three times
// the tensor-core work of one pass over the same tiles.
//
// Bound on the H100: tensor-core math.  At M=4096, N=8192, K=8 the lower
// triangle alone is K*N*M^2/2 = 5.5e11 multiply-adds (1.1 TFLOP, 1.1 ms at
// the 989 TFLOP/s bf16 peak) against ~0.74 GB of compulsory traffic (A,
// tril L, B16), so it has to run on the bf16 tensor cores at their full
// rate, which only wgmma reaches.  Precision is the TPU's class: bf16
// operands, fp32 accumulators held over the whole m-run, one rounding to the
// output type at the end; never bf16 accumulation or TF32.
//
// Design (Hopper; mbarriers, TMA, descriptors, wgmma and the zeroing are
// hopper.cuh's, shared with tril_bwd.cu; the mainloop is
// tril_product.cuh's, shared with quad.cu): the product is a GEMM with
// wgmma's M = n (64-row slabs), N = m' (BP = 256) and K = m.  A [M, N] is
// n-contiguous and L_k [M, M] is m'-contiguous, so both tiles are MN-major
// operands as they lie in memory, which bf16 wgmma reads through the
// transpose bits: no transpose anywhere.
// A persistent grid of one CTA per SM walks a list of 128 (n) x 256 (m')
// output tiles ordered by m'-tile, so the longest m-runs (m' near 0, m from
// m' to M) come first and the short ones fill the tail; the k and n-tile of
// one m'-tile are adjacent, so an A strip and K L strips serve a wave from
// L2.  Per CTA one producer warp issues TMA loads (128-byte swizzle) of the
// A tile [64 m][2 x 64 n] and the L tile [64 m][4 x 64 m'] into a ring of
// four stages with full / empty mbarriers; two consumer warpgroups each run
// wgmma m64n256k16 over their 64 n-rows, 4 per stage, into 128 fp32
// registers a thread held over the whole m-run, one stage's group kept in
// flight while the next is issued.  (On an H100 at 700 W the 256-wide tile
// ran #3's main shape in 2.06 ms against 2.26 for a 128-wide one, and six
// stages of the 128-wide tile in 2.39.)  Only tiles on or below the
// diagonal are visited: the m-run of m'-tile p starts at m = p0.  The L tiles
// that straddle the diagonal (the first BP / 64 stages of every m-run) get
// their entries with m < m' overwritten with 0 in shared memory by the
// consumers after the TMA lands (a store, never a multiply: NaN * 0 is NaN),
// then a proxy fence and a barrier of the two warpgroups before wgmma reads
// them, so garbage or NaN above L's diagonal never enters the sum.  The
// epilogue rounds each accumulator once and stores pairs straight to
// B [K, N, M] (m' contiguous) with masks at the N and M edges.
//
// Alignment rule: TMA needs 16-byte row strides, so the wrapper hands in A
// with lda = N rounded up to a multiple of 8 and L with ldl = M rounded up
// to a multiple of 8, padding with zero columns (A) or zero rows and
// columns (L) into scratch where N or M is not such a multiple.  Reads past
// the arrays are zero-filled by TMA; the kernel takes m < M only and stores
// n < N, m' < M only, so B's own stride is M whatever the padding.
#include "tril_product.cuh"

namespace {

using namespace mgp;

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b, bool both, bool vec) {
  if (both && vec) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
  } else {
    dst[0] = __float2bfloat16_rn(a);
    if (both) dst[1] = __float2bfloat16_rn(b);
  }
}

__device__ __forceinline__ void store2(float* dst, float a, float b, bool both, bool vec) {
  if (both && vec) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  } else {
    dst[0] = a;
    if (both) dst[1] = b;
  }
}

// The epilogue: each accumulator rounded once to OutT and stored in pairs
// to B [K, N, M] (m' contiguous), masked at the N and M edges.
template <typename OutT>
struct StoreB {
  OutT* B;
  int M, N;
  __device__ __forceinline__ void operator()(float (&acc)[TP_NACC], int k, int p, int n0,
                                             int wg, int lt) const {
    const int lane = lt % 32, wq = lt / 32;
    const bool vec = (M % 2) == 0;
    const int p0 = p * TP_BP;
    OutT* Bk = B + (size_t)k * N * M;
    const int row = n0 + 64 * wg + 16 * wq + lane / 4;
#pragma unroll
    for (int c = 0; c < TP_BP / 8; ++c) {
      const int mp = p0 + 8 * c + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = row + 8 * h;
        if (n < N && mp < M)
          store2(Bk + (size_t)n * M + mp, acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1],
                 mp + 1 < M, vec);
      }
    }
  }
};

// The split forward's epilogue: B in f32, and the row square sums.
struct StoreBSquareSums {
  StoreB<float> store;
  RowSquareSums sums;
  __device__ __forceinline__ void operator()(float (&acc)[TP_NACC], int k, int p, int n0,
                                             int wg, int lt) const {
    store(acc, k, p, n0, wg, lt);
    sums(acc, k, p, n0, wg, lt);
  }
};

__global__ void __launch_bounds__(TP_NTHR, 1)
tril_fwd_split_kernel(const __grid_constant__ CUtensorMap mapA,
                      const __grid_constant__ CUtensorMap mapL, float* __restrict__ B,
                      float* __restrict__ part, int M, int N, int K) {
  tril_product<3>(&mapA, &mapL, M, N, K,
                  StoreBSquareSums{{B, M, N}, {part, N, (M + TP_BP - 1) / TP_BP}});
}

template <typename OutT>
__global__ void __launch_bounds__(TP_NTHR, 1)
tril_fwd_kernel(const __grid_constant__ CUtensorMap mapA,
                const __grid_constant__ CUtensorMap mapL, OutT* __restrict__ Bout,
                int M, int N, int K) {
  tril_product(&mapA, &mapL, M, N, K, StoreB<OutT>{Bout, M, N});
}

template <typename OutT>
int launch(const void* A, const void* L, void* B, int M, int N, int K, int lda, int ldl,
           void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  return launch_tril_product(tril_fwd_kernel<OutT>, A, L, M, N, K, lda, ldl, stream,
                             static_cast<OutT*>(B), M, N, K);
}

}  // namespace

// A [M, lda] bf16 (columns past N zero), L [K, ldl, ldl] bf16 (upper triangle
// ignored; rows and columns past M zero), lda and ldl multiples of 8 ->
// B [K, N, M] bf16.
extern "C" int mgp_tril_fwd(const void* A, const void* L, void* B, int M, int N, int K,
                            int lda, int ldl, void* stream) {
  return launch<__nv_bfloat16>(A, L, B, M, N, K, lda, ldl, stream);
}

// The same contraction -> B [K, N, M] f32.
extern "C" int mgp_tril_fwd_f32(const void* A, const void* L, void* B, int M, int N, int K,
                                int lda, int ldl, void* stream) {
  return launch<float>(A, L, B, M, N, K, lda, ldl, stream);
}

// A2 [2, M, lda] bf16 (A_hi, then A_lo; columns past N zero), L2 [2K, ldl,
// ldl] bf16 (L_hi, then L_lo; upper triangles ignored; rows and columns
// past M zero), lda and ldl multiples of 8; part [K, ceil(M / 256), N] f32
// scratch -> B [K, N, M] f32 and extra [K, N] f32.
extern "C" int mgp_tril_fwd_split(const void* A2, const void* L2, void* B, void* part,
                                  void* extra, int M, int N, int K, int lda, int ldl,
                                  void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  int err = launch_tril_product<3>(tril_fwd_split_kernel, A2, L2, M, N, K, lda, ldl, stream,
                                   static_cast<float*>(B), static_cast<float*>(part), M, N,
                                   K);
  if (err != 0) return err;
  return launch_partial_sums(static_cast<const float*>(part), static_cast<float*>(extra), K,
                             M, N, stream);
}
