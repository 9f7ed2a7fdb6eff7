// Blocked substitution for a lower-triangular L: forward, X = L^-1 B, and
// backward, X = L^-T B.
//
// Replaces modulatedgps_tpu/ops/pallas_linalg.py:_trsm_kernel (with its
// _chol_diag_inverses and the 512-row panel loop of _trsm_large_impl) and
// _trsm_t_kernel (the transposed solve: the unwhitened conditional's second
// solve and the pullback of every forward solve).
//
// With a general B (Nb = 8192 or 32768 columns on the unwhitened path) there
// are hundreds of strips and the solve is bound by the fp32 FMA rate from
// shared memory (M^2 Nb / 2 multiply-adds), not by the critical walk.
//
// Bound on the H100: the substitution is sequential over block rows, so the
// critical path is one column strip's walk down the matrix (about
// (M/64)^2/2 tile products of 64x64xTW fp32 FMAs for the first strip of an
// inverse), not memory.  fp32 FMA only: the TPU ran these products at
// HIGHEST.  Design, two launches:
//   (a) one CUDA block per 64x64 diagonal block inverts it by substitution
//       in shared memory (a ragged tail is padded with the identity); a
//       caller holding the inverses from the Cholesky (chol.cu, which
//       launches this same kernel through mgp_diag_inv) skips it;
//   (b) one CUDA block per TW-column strip of B walks the block rows in
//       order: acc = B_k - sum_{j<k} L_kj X_j, then X_k = Inv_kk acc.
//       The TPU's sequential fori_loop over row blocks becomes this in-block
//       loop; strips run in parallel with nothing carried between them.
//       Narrow strips (TW=16) shorten the critical walk and give ~2 blocks
//       per SM at M=4096; the next (L_kj, X_j) tile pair is loaded into
//       registers while the current one is multiplied, hiding L2 latency.
//       With B = I (unit_rhs, B is then not read) a strip starts at the
//       block row holding its first column: the rows of L^-1 above are zero.
//       The transposed solve is the same kernel walking the block rows from
//       the last up (solve_kernel<true>); it reuses (a), since the diagonal
//       blocks of L^T have the inverses Inv_kk^T.
#include <cuda_runtime.h>

namespace {

constexpr int BS = 64;        // diagonal block size
constexpr int TW = 16;        // columns per strip
constexpr int NT = 256;       // threads per solve block
constexpr int RY = NT / TW;   // thread rows (16)
constexpr int RR = BS / RY;   // rows per thread (4)
constexpr int LPT = BS * BS / NT;  // L-tile elements per thread (16)
constexpr int XPT = BS * TW / NT;  // X-tile elements per thread (4)

__global__ void __launch_bounds__(BS)
diag_inv_kernel(const float* __restrict__ L, float* __restrict__ Inv, int M) {
  __shared__ float Ls[BS][BS + 1];
  __shared__ float Xs[BS][BS + 1];
  const int base = blockIdx.x * BS;
  const int j = threadIdx.x;
  for (int i = 0; i < BS; ++i) {
    int r = base + i, c = base + j;
    float v;
    if (r < M && c < M) v = (j <= i) ? L[(size_t)r * M + c] : 0.f;
    else v = (i == j) ? 1.f : 0.f;
    Ls[i][j] = v;
  }
  __syncthreads();
  // Thread j forms column j of the inverse; it reads only its own column.
  for (int i = 0; i < BS; ++i) {
    float acc = (i == j) ? 1.f : 0.f;
    for (int p = j; p < i; ++p) acc = fmaf(-Ls[i][p], Xs[p][j], acc);
    Xs[i][j] = (i >= j) ? acc / Ls[i][i] : 0.f;
  }
  float* out = Inv + (size_t)blockIdx.x * BS * BS;
  for (int i = 0; i < BS; ++i) out[i * BS + j] = Xs[i][j];
}

// kTrans = false: L X = B, block rows in order, acc = B_k - sum_{j<k} L_kj X_j,
// X_k = Inv_kk acc.  kTrans = true: L^T X = B, block rows in reverse,
// acc = B_k - sum_{j>k} L_jk^T X_j, X_k = Inv_kk^T acc (the diagonal blocks of
// L^T have the inverses Inv_kk^T).  The transposed solve reads L_jk and
// Inv_kk row by row from device memory (coalesced) and stores them
// transposed into shared memory, so the product loop is the same for both.
template <bool kTrans>
__global__ void __launch_bounds__(NT)
solve_kernel(const float* __restrict__ L, const float* __restrict__ Inv,
             const float* __restrict__ B, float* __restrict__ X, int M, int Nb,
             int unit_rhs) {
  __shared__ float Ls[BS][BS + 1];
  __shared__ float Xs[BS][TW + 1];
  const int tid = threadIdx.x;
  const int tx = tid % TW, ty = tid / TW;
  const int c0 = blockIdx.x * TW;
  const int col = c0 + tx;
  const bool col_ok = col < Nb;
  const int nblk = (M + BS - 1) / BS;
  const int kstart = (!kTrans && unit_rhs) ? c0 / BS : 0;

  if (col_ok)
    for (int r = ty; r < min(kstart * BS, M); r += RY) X[(size_t)r * Nb + col] = 0.f;

  // Element e of a [BS, BS] tile read row-major, stored as Ls[e / BS][e % BS]
  // or, transposed, as Ls[e % BS][e / BS] (stride BS + 1: no bank conflicts).
  auto stage = [&](int e, float v) {
    if (kTrans) Ls[e % BS][e / BS] = v;
    else Ls[e / BS][e % BS] = v;
  };

  // Registers for the next (L tile, X_j) pair: L_kj (forward, j < k) or
  // L_jk (transposed, j > k).  The tile's columns are inside M (they belong
  // to the smaller of j, k, never the last block); its rows, and X_j's, may
  // run past M in the transposed solve's last block row and read as 0.
  float lr[LPT], xr[XPT];
  auto fetch = [&](int k, int j) {
    const int rb = kTrans ? j : k, cb = kTrans ? k : j;
#pragma unroll
    for (int q = 0; q < LPT; ++q) {
      const int e = tid + q * NT;
      const int r = rb * BS + e / BS;
      lr[q] = (r < M) ? L[(size_t)r * M + cb * BS + e % BS] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < XPT; ++q) {
      const int e = tid + q * NT;
      const int c = c0 + e % TW;
      const int r = j * BS + e / TW;
      xr[q] = (c < Nb && r < M) ? X[(size_t)r * Nb + c] : 0.f;
    }
  };

  for (int s = 0; s < nblk - kstart; ++s) {
    const int k = kTrans ? nblk - 1 - s : kstart + s;
    const int jlo = kTrans ? k + 1 : kstart;   // the substituted block rows
    const int jhi = kTrans ? nblk : k;
    float acc[RR];
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      int r = k * BS + ty + i * RY;
      if (unit_rhs) acc[i] = (r == col) ? 1.f : 0.f;
      else acc[i] = (r < M && col_ok) ? B[(size_t)r * Nb + col] : 0.f;
    }
    if (jlo < jhi) fetch(k, jlo);
    for (int j = jlo; j < jhi; ++j) {
#pragma unroll
      for (int q = 0; q < LPT; ++q) stage(tid + q * NT, lr[q]);
#pragma unroll
      for (int q = 0; q < XPT; ++q) {
        const int e = tid + q * NT;
        Xs[e / TW][e % TW] = xr[q];
      }
      __syncthreads();
      if (j + 1 < jhi) fetch(k, j + 1);
#pragma unroll 16
      for (int p = 0; p < BS; ++p) {
        float xv = Xs[p][tx];
#pragma unroll
        for (int i = 0; i < RR; ++i) acc[i] = fmaf(-Ls[ty + i * RY][p], xv, acc[i]);
      }
      __syncthreads();
    }
    // X_k = Inv_kk acc (forward) or Inv_kk^T acc (transposed)
#pragma unroll
    for (int i = 0; i < RR; ++i) Xs[ty + i * RY][tx] = acc[i];
    const float* inv = Inv + (size_t)k * BS * BS;
#pragma unroll
    for (int q = 0; q < LPT; ++q) stage(tid + q * NT, inv[tid + q * NT]);
    __syncthreads();
    float out[RR];
#pragma unroll
    for (int i = 0; i < RR; ++i) out[i] = 0.f;
#pragma unroll 16
    for (int p = 0; p < BS; ++p) {
      float xv = Xs[p][tx];
#pragma unroll
      for (int i = 0; i < RR; ++i) out[i] = fmaf(Ls[ty + i * RY][p], xv, out[i]);
    }
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      int r = k * BS + ty + i * RY;
      if (r < M && col_ok) X[(size_t)r * Nb + col] = out[i];
    }
    // Makes X_k visible to the whole block before a later row reads it,
    // and frees the shared tiles.
    __syncthreads();
  }
}

}  // namespace

// Inv [ceil(M / 64), 64, 64], the inverses of the 64x64 diagonal blocks of L
// [M, M] lower (upper triangle ignored), the last block of a ragged M padded
// with the identity: the solves' first launch, and chol.cu's last.
extern "C" int mgp_diag_inv(const void* L, void* inv, int M, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 0)
    diag_inv_kernel<<<(M + BS - 1) / BS, BS, 0, s>>>(static_cast<const float*>(L),
                                                     static_cast<float*>(inv), M);
  return static_cast<int>(cudaGetLastError());
}

// L [M, M] lower (upper triangle ignored), B [M, Nb], X [M, Nb], inv
// [ceil(M / 64), 64, 64]; all fp32 on the device.  With unit_rhs the right
// side is the identity (Nb == M) and B may be null.  With inv_given, inv
// already holds the diagonal-block inverses (the Cholesky writes them) and
// (a) is skipped; otherwise it is scratch that (a) fills.
extern "C" int mgp_trsm_lower(const void* L, void* inv, const void* B, void* X,
                              int M, int Nb, int unit_rhs, int inv_given,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 0 && Nb > 0) {
    if (!inv_given) mgp_diag_inv(L, inv, M, stream);
    solve_kernel<false><<<(Nb + TW - 1) / TW, NT, 0, s>>>(
        static_cast<const float*>(L), static_cast<const float*>(inv),
        static_cast<const float*>(B), static_cast<float*>(X), M, Nb, unit_rhs);
  }
  return static_cast<int>(cudaGetLastError());
}

// X = L^-T B: L [M, M] lower (upper triangle ignored), B and X [M, Nb], inv
// [ceil(M / 64), 64, 64] given or scratch as above; all fp32 on the device.
extern "C" int mgp_trsm_lower_t(const void* L, void* inv, const void* B, void* X,
                                int M, int Nb, int inv_given, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 0 && Nb > 0) {
    if (!inv_given) mgp_diag_inv(L, inv, M, stream);
    solve_kernel<true><<<(Nb + TW - 1) / TW, NT, 0, s>>>(
        static_cast<const float*>(L), static_cast<const float*>(inv),
        static_cast<const float*>(B), static_cast<float*>(X), M, Nb, 0);
  }
  return static_cast<int>(cudaGetLastError());
}
