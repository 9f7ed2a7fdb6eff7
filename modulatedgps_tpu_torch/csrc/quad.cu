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
// N=8192) the lower triangle is K*N*M(M+1)/2 = 5.5e11 multiply-adds (1.11
// ms at the 989 TFLOP/s bf16 peak) against ~0.34 GB of compulsory traffic
// (S16, A16, the [K, N] output).  Precision is the TPU's class for this
// term (an f32 einsum at DEFAULT precision, one bf16 pass): bf16 operands,
// fp32 accumulators held over each whole m-run, the square and the sums in
// fp32; never bf16 accumulation or TF32.
// Design: the product is the tril forward's (#3, tril_fwd.cu) with S_k in
// L_k's place: S_k is m'-contiguous and A n-contiguous, so both are MN-major
// wgmma operands as they lie in memory.  tril_product.cuh runs it: a
// persistent grid over 128 (n) x 256 (m') tiles, longest m-runs first with
// the k and n-tiles of one m'-tile adjacent for L2 reuse, a producer warp
// issuing 128-byte-swizzled TMA into a four-stage ring, two consumer
// warpgroups of wgmma m64n256k16, S's entries above the diagonal stored as 0
// in shared memory (never multiplied: NaN * 0 is NaN) before a proxy fence.
// Only the epilogue differs: each thread squares its 128 fp32 accumulators
// and sums them along m' for each of its two rows, the four threads of a
// quad combine theirs with two shuffles, and one lane writes the tile's row
// sum to part [K, ceil(M / 256), N]; a second launch adds each (k, n)'s
// partial sums over the m'-tiles in order.  No atomics: two runs give the
// same bits.
//
// Alignment rule: as for tril_fwd.cu, the wrapper hands in A with lda = N
// and S with lds = M rounded up to multiples of 8 (zero padding where
// needed); padded columns m' >= M and rows n >= N give zero products, and
// rows n >= N are not stored.
#include "tril_product.cuh"

namespace {

using namespace mgp;

__global__ void __launch_bounds__(TP_NTHR, 1)
quad_kernel(const __grid_constant__ CUtensorMap mapA, const __grid_constant__ CUtensorMap mapS,
            float* __restrict__ part, int M, int N, int K) {
  tril_product(&mapA, &mapS, M, N, K, RowSquareSums{part, N, (M + TP_BP - 1) / TP_BP});
}

}  // namespace

// S [K, lds, lds] bf16 (upper triangle ignored; rows and columns past M
// zero), A [M, lda] bf16 (columns past N zero), lda and lds multiples of 8;
// part [K, ceil(M / 256), N] f32 scratch -> out [K, N] f32.
extern "C" int mgp_qsqrt_sq_colsum(const void* S, const void* A, void* part, void* out,
                                   int M, int N, int K, int lda, int lds, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  int err = launch_tril_product(quad_kernel, A, S, M, N, K, lda, lds, stream,
                                static_cast<float*>(part), M, N, K);
  if (err != 0) return err;
  return launch_partial_sums(static_cast<const float*>(part), static_cast<float*>(out), K, M,
                             N, stream);
}
