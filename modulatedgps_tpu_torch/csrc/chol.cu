// Lower Cholesky factor L of an SPD [M, M] f32 matrix and the inverses of
// its 64x64 diagonal blocks, by a right-looking blocked factorization.
//
// Replaces modulatedgps_tpu/ops/pallas_linalg.py:_chol_kernel (the whole
// matrix resident in VMEM, M <= 1024) and _chol_kernel_large (the same loop
// at M = 4096 with a DMA'd input and dynamic loop bounds).  On the TPU they
// were two kernels only because of VMEM; here one C entry serves every M.
//
// Bound on the H100: M^3 / 3 fp32 operations (2.3e10 at M = 4096, 0.34 ms
// at the 67 TFLOP/s fp32 peak) against 2 * 4 * M^2 bytes (0.04 ms), so
// arithmetic in principle; in practice the 64 diagonal blocks factor one
// after another and each is 64 sequential column steps, so the critical
// path is the chain of diagonal-block kernels and the launches between
// them.  fp32 FMAs only: the TPU ran every dot at HIGHEST, and anything
// that feeds the Cholesky stays full fp32 (never TF32).  Design, one host
// loop over block columns j (one ctypes call per factorization):
//   (a) chol_diag_kernel: one CTA factors the 64x64 tile A_jj in shared memory
//       by column steps (sqrt, scale, rank-1 update: _unblocked_chol_and_inv,
//       pallas_linalg.py:41-84) and writes L_jj (exact zeros above the
//       diagonal);
//   (b) chol_panel_kernel: one CTA per tile below the diagonal solves
//       P_ij L_jj^T = A_ij in place by substitution (column steps in shared
//       memory).  The TPU kernel multiplied by Inv_j^T instead, which on
//       an ill-conditioned Kmm (the assignment layer's) puts the f32
//       factor further from f64 than substitution does;
//   (c) chol_update_kernel: one CTA per lower tile (i, k), j < k <= i, forms
//       A_ik -= P_ij P_kj^T (only the lower tiles, as the TPU kernel's
//       dynamic loop bounds visit): 256 threads, each a 4x4 register tile
//       fed by float4 loads from the two operands staged transposed in
//       shared memory.
// After the loop, trsm.cu's own diag_inv_kernel (through mgp_diag_inv)
// inverts every diagonal block at once, off the critical path, so Inv is by
// construction what a solve would compute from L.  A ragged M is padded with
// the identity inside (a) and the inverse (the pad never reaches L) and
// masked in (b) and (c).  A pivot that is not positive (or NaN)
// becomes NaN, which then fills every later column, as
// jnp.linalg.cholesky gives NaN: no host sync reads an info code.
#include <cuda_runtime.h>

// trsm.cu: the inverses of L's 64x64 diagonal blocks, its solves' first launch.
extern "C" int mgp_diag_inv(const void* L, void* inv, int M, void* stream);

namespace {

constexpr int BS = 64;          // block size (trsm.cu's diagonal block size)
constexpr int NT = 256;         // threads per CTA: 16 x 16, 4x4 entries each
constexpr int LDT = BS + 4;     // row pitch of the transposed tiles (float4 aligned)

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// L = tril(A), exact zeros above the diagonal: the working copy.
__global__ void chol_copy_kernel(const float* __restrict__ A, float* __restrict__ L,
                                  int M) {
  const size_t total = (size_t)M * M;
  for (size_t e = blockIdx.x * (size_t)NT + threadIdx.x; e < total;
       e += (size_t)gridDim.x * NT) {
    const int r = (int)(e / M), c = (int)(e % M);
    L[e] = (c <= r) ? A[e] : 0.f;
  }
}

__global__ void __launch_bounds__(NT)
chol_diag_kernel(float* __restrict__ L, int M, int j) {
  __shared__ float s[BS][BS + 1];   // the tile, factored in place
  const int base = j * BS;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  for (int e = tid; e < BS * BS; e += NT) {
    const int i = e / BS, c = e % BS;
    const int r = base + i, cc = base + c;
    float v;
    if (r < M && cc < M) v = (c <= i) ? L[(size_t)r * M + cc] : 0.f;
    else v = (i == c) ? 1.f : 0.f;        // identity pad of a ragged tail
    s[i][c] = v;
  }
  __syncthreads();

  // Column steps, one barrier each.  Thread (ty, tx) owns rows ty + 16a and
  // columns tx + 16b.  At step k every thread scales the entries of column
  // k it needs by 1 / sqrt(pivot) itself and updates its entries of the
  // later columns; after the barrier, when no thread reads column k any
  // more, its owners store it scaled (the next step reads column k + 1).
  for (int k = 0; k < BS; ++k) {
    const float a = s[k][k];
    const float d = (a > 0.f) ? sqrtf(a) : nan_f();
    const float rd = 1.f / d;
#pragma unroll
    for (int ia = 0; ia < 4; ++ia) {
      const int i = ty + 16 * ia;
      if (i <= k) continue;
      const float lik = s[i][k] * rd;
#pragma unroll
      for (int cb = 0; cb < 4; ++cb) {
        const int c = tx + 16 * cb;
        if (c > k && c <= i) s[i][c] = fmaf(-lik, s[c][k] * rd, s[i][c]);
      }
    }
    __syncthreads();
    if (tx == k % 16) {
#pragma unroll
      for (int ia = 0; ia < 4; ++ia) {
        const int i = ty + 16 * ia;
        if (i == k) s[k][k] = d;
        else if (i > k) s[i][k] *= rd;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < BS * BS; e += NT) {
    const int i = e / BS, c = e % BS;
    const int r = base + i, cc = base + c;
    if (r < M && cc < M) L[(size_t)r * M + cc] = (c <= i) ? s[i][c] : 0.f;
  }
}

// C -= A B^T for [64, 64] tiles: A's and C's rows past rows_a and B's rows
// (C's columns) past rows_b read as 0 and are not written.
__device__ __forceinline__ void tile_sub_nt(const float* __restrict__ A, int lda,
                                            int rows_a, const float* __restrict__ B,
                                            int ldb, int rows_b, float* C, int ldc) {
  __shared__ __align__(16) float At[BS][LDT];
  __shared__ __align__(16) float Bt[BS][LDT];
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < BS * BS / NT; ++q) {
    const int e = tid + q * NT;
    const int r = e / BS, p = e % BS;
    At[p][r] = (r < rows_a) ? A[(size_t)r * lda + p] : 0.f;
    Bt[p][r] = (r < rows_b) ? B[(size_t)r * ldb + p] : 0.f;
  }
  __syncthreads();
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
#pragma unroll 8
  for (int p = 0; p < BS; ++p) {
    const float4 a = *reinterpret_cast<const float4*>(&At[p][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&Bt[p][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows_a) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int cc = tx * 4 + c;
      if (cc < rows_b) C[(size_t)r * ldc + cc] -= acc[i][c];
    }
  }
}

// Block row i = j + 1 + blockIdx.x: P_ij L_jj^T = A_ij by substitution, in
// place.  Column steps: at step c column c of P is final, P[r][c] = acc * (1 / L[c][c]), and each later column folds it in,
// acc[r][c'] = fma(-P[r][c], L[c'][c], acc[r][c']).
__global__ void __launch_bounds__(NT)
chol_panel_kernel(float* __restrict__ L, int M, int j) {
  __shared__ float l[BS][BS + 1];   // L_jj
  __shared__ float x[BS][BS + 1];   // P_ij
  const int i = j + 1 + blockIdx.x;
  const int rows = min(BS, M - i * BS);
  float* Aij = L + (size_t)i * BS * M + (size_t)j * BS;
  const float* Ljj = L + (size_t)j * BS * M + (size_t)j * BS;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  __shared__ float rdiag[BS];       // 1 / L_jj[c][c]
  for (int e = tid; e < BS * BS; e += NT) {
    const int r = e / BS, c = e % BS;
    l[r][c] = Ljj[(size_t)r * M + c];    // j < nblk - 1: the tile is inside M
  }
  if (tid < BS) rdiag[tid] = 1.f / Ljj[(size_t)tid * M + tid];
  float acc[4][4];
#pragma unroll
  for (int ra = 0; ra < 4; ++ra)
#pragma unroll
    for (int cb = 0; cb < 4; ++cb) {
      const int r = ty + 16 * ra;
      acc[ra][cb] = (r < rows) ? Aij[(size_t)r * M + tx + 16 * cb] : 0.f;
    }
  __syncthreads();
  for (int c = 0; c < BS; ++c) {
    if (tx == c % 16) {
      const int cb = c / 16;
#pragma unroll
      for (int ra = 0; ra < 4; ++ra)
#pragma unroll
        for (int q = 0; q < 4; ++q)   // static register index
          if (q == cb) x[ty + 16 * ra][c] = acc[ra][q] * rdiag[c];
    }
    __syncthreads();
#pragma unroll
    for (int cb = 0; cb < 4; ++cb) {
      const int cc = tx + 16 * cb;
      if (cc <= c) continue;
      const float lcc = l[cc][c];
#pragma unroll
      for (int ra = 0; ra < 4; ++ra)
        acc[ra][cb] = fmaf(-x[ty + 16 * ra][c], lcc, acc[ra][cb]);
    }
  }
  __syncthreads();
  for (int e = tid; e < BS * BS; e += NT) {
    const int r = e / BS, c = e % BS;
    if (r < rows) Aij[(size_t)r * M + c] = x[r][c];
  }
}

// Lower tile t of the trailing matrix (row-major over i, then k <= i):
// A_ik -= P_ij P_kj^T.
__global__ void __launch_bounds__(NT)
chol_update_kernel(float* L, int M, int j) {
  const int t = blockIdx.x;
  int io = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (io * (io + 1) / 2 > t) --io;
  while ((io + 1) * (io + 2) / 2 <= t) ++io;
  const int i = j + 1 + io, k = j + 1 + (t - io * (io + 1) / 2);
  const int rows_i = min(BS, M - i * BS), rows_k = min(BS, M - k * BS);
  tile_sub_nt(L + (size_t)i * BS * M + (size_t)j * BS, M, rows_i,
              L + (size_t)k * BS * M + (size_t)j * BS, M, rows_k,
              L + (size_t)i * BS * M + (size_t)k * BS, M);
}

}  // namespace

// A [M, M] SPD (lower triangle read), L [M, M] row-major with exact zeros
// above the diagonal, Inv [ceil(M / 64), 64, 64]: all fp32 on the device.
extern "C" int mgp_cholesky(const void* A, void* L, void* Inv, int M, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  float* l = static_cast<float*>(L);
  const size_t total = (size_t)M * M;
  const int grid = (int)((total + NT - 1) / NT < 4096 ? (total + NT - 1) / NT : 4096);
  chol_copy_kernel<<<grid, NT, 0, s>>>(static_cast<const float*>(A), l, M);
  cudaError_t err = cudaGetLastError();
  const int nblk = (M + BS - 1) / BS;
  for (int j = 0; j < nblk && err == cudaSuccess; ++j) {
    chol_diag_kernel<<<1, NT, 0, s>>>(l, M, j);
    const int n = nblk - j - 1;
    if (n > 0) {
      chol_panel_kernel<<<n, NT, 0, s>>>(l, M, j);
      chol_update_kernel<<<n * (n + 1) / 2, NT, 0, s>>>(l, M, j);
    }
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return mgp_diag_inv(l, Inv, M, stream);
}
