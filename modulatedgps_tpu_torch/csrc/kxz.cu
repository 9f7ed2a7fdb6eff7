// Fused stationary-kernel matrix K[n, m] = var * phi(|x_n / l - z_m / l|^2).
//
// Replaces modulatedgps_tpu/ops/pallas_kernels.py:_kxz_pallas
// (_dist_kernel_body + _rbf_epilogue / _matern32_epilogue).
//
// Bound on the H100: the N*M*4-byte store (134 MB for K(Z, X) at M=4096,
// N=8192).  D is small (4 on the main path), so the cross term is a few fp32
// FMAs per output; tensor cores and TF32 are never used, matching the TPU
// kernel's HIGHEST cross term.  Design: a [TILE_N, TILE_M] output tile per
// block; the scaled X and Z rows of the tile are staged in shared memory in
// chunks of D_CHUNK, each thread keeps 4x4 accumulators in registers, and
// neighbouring threads own neighbouring m so every row store coalesces.
// The arithmetic is the TPU's: |x|^2 + |z|^2 - 2 x.z, clamped at 0, then the
// epilogue with the signal variance folded in.  Ragged N, M and D are masked.
#include <cuda_runtime.h>

namespace {

constexpr int TILE_N = 32;     // rows (x) per block
constexpr int TILE_M = 128;    // columns (z) per block
constexpr int TX = 32;         // threads along m
constexpr int TY = 8;          // threads along n
constexpr int RN = TILE_N / TY;  // rows per thread
constexpr int RM = TILE_M / TX;  // columns per thread
constexpr int D_CHUNK = 16;

enum Epilogue { RBF = 0, MATERN32 = 1 };

template <int EPI>
__device__ __forceinline__ float epilogue(float d2, float var) {
  if (EPI == RBF) {
    return var * expf(-0.5f * d2);
  } else {
    const float s3 = 1.7320508075688772f;
    float r = sqrtf(d2 + 1e-36f);
    return var * (1.0f + s3 * r) * expf(-s3 * r);
  }
}

template <int EPI>
__global__ void __launch_bounds__(TX * TY)
kxz_kernel(const float* __restrict__ X, const float* __restrict__ Z,
           const float* __restrict__ ls, const float* __restrict__ var_ptr,
           float* __restrict__ out, int N, int M, int D) {
  __shared__ float xs[D_CHUNK][TILE_N + 1];
  __shared__ float zs[D_CHUNK][TILE_M + 1];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int n0 = blockIdx.y * TILE_N;
  const int m0 = blockIdx.x * TILE_M;

  float cross[RN][RM], xn[RN], zn[RM];
#pragma unroll
  for (int i = 0; i < RN; ++i) {
    xn[i] = 0.f;
#pragma unroll
    for (int j = 0; j < RM; ++j) cross[i][j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < RM; ++j) zn[j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += D_CHUNK) {
    // Stage the scaled chunk: x / l and z / l, zero outside the ranges.
    for (int e = tid; e < TILE_N * D_CHUNK; e += TX * TY) {
      int r = e / D_CHUNK, d = e % D_CHUNK;
      int n = n0 + r, dd = d0 + d;
      xs[d][r] = (n < N && dd < D) ? X[(size_t)n * D + dd] / ls[dd] : 0.f;
    }
    for (int e = tid; e < TILE_M * D_CHUNK; e += TX * TY) {
      int r = e / D_CHUNK, d = e % D_CHUNK;
      int m = m0 + r, dd = d0 + d;
      zs[d][r] = (m < M && dd < D) ? Z[(size_t)m * D + dd] / ls[dd] : 0.f;
    }
    __syncthreads();
    const int dlim = min(D_CHUNK, D - d0);
    for (int d = 0; d < dlim; ++d) {
      float xv[RN], zv[RM];
#pragma unroll
      for (int i = 0; i < RN; ++i) xv[i] = xs[d][ty + i * TY];
#pragma unroll
      for (int j = 0; j < RM; ++j) zv[j] = zs[d][tx + j * TX];
      // Squares rounded before the add, as the plain version's sum(x**2).
#pragma unroll
      for (int i = 0; i < RN; ++i) xn[i] = __fadd_rn(xn[i], __fmul_rn(xv[i], xv[i]));
#pragma unroll
      for (int j = 0; j < RM; ++j) zn[j] = __fadd_rn(zn[j], __fmul_rn(zv[j], zv[j]));
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int j = 0; j < RM; ++j) cross[i][j] = fmaf(xv[i], zv[j], cross[i][j]);
    }
    __syncthreads();
  }

  const float var = *var_ptr;
#pragma unroll
  for (int i = 0; i < RN; ++i) {
    int n = n0 + ty + i * TY;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < RM; ++j) {
      int m = m0 + tx + j * TX;
      if (m >= M) continue;
      float d2 = fmaxf(xn[i] + zn[j] - 2.0f * cross[i][j], 0.0f);
      out[(size_t)n * M + m] = epilogue<EPI>(d2, var);
    }
  }
}

}  // namespace

// X [N, D], Z [M, D], ls [D], var [1] (all fp32, device) -> out [N, M].
// kind 0 = squared exponential, 1 = Matern-3/2.
extern "C" int mgp_kxz(const void* X, const void* Z, const void* ls,
                       const void* var, void* out, int N, int M, int D,
                       int kind, void* stream) {
  dim3 block(TX, TY);
  dim3 grid((M + TILE_M - 1) / TILE_M, (N + TILE_N - 1) / TILE_N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N > 0 && M > 0) {
    if (kind == MATERN32) {
      kxz_kernel<MATERN32><<<grid, block, 0, s>>>(
          static_cast<const float*>(X), static_cast<const float*>(Z),
          static_cast<const float*>(ls), static_cast<const float*>(var),
          static_cast<float*>(out), N, M, D);
    } else {
      kxz_kernel<RBF><<<grid, block, 0, s>>>(
          static_cast<const float*>(X), static_cast<const float*>(Z),
          static_cast<const float*>(ls), static_cast<const float*>(var),
          static_cast<float*>(out), N, M, D);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
