// The whitened KL's q_sqrt terms over the lower triangle of Lq [K, M, M] f32:
//
//   forward   (sum_{j <= i} Lq[k, i, j]^2,  sum_i log|Lq[k, i, i]|)
//   backward  dLq[k, i, j] = g (Lq[k, i, j] - [i == j] / Lq[k, i, i])  for j <= i,
//             exactly 0 for j > i.
//
// Replaces modulatedgps_tpu/ops/pallas_kl.py:_k_fwd (kl_sq_logdiag) and _k_bwd
// (kl_bwd_scale).
//
// Bound on the H100: device memory.  At M=4096, K=8 the forward reads the
// lower triangle once (2.7e8 B, ~0.08 ms at 3.35 TB/s) and the backward reads
// it and writes the whole [K, M, M] (8.1e8 B, ~0.24 ms); the arithmetic is a
// few operations a byte.  So both are streaming passes: 16-byte loads and
// stores, no shared-memory staging, and the strictly-upper half is never read.
//
// Forward design: block (p, k) sums rows p and M-1-p of Lq[k] up to the
// diagonal (M+1 entries, so every block has the same work) and writes one fp32
// partial of each sum; a second one-block pass adds the K*ceil(M/2) partials in
// a fixed order, in double.  No atomics, so the result is the same bits on
// every run and a resumed training run reproduces its losses.
//
// Backward design: block (i, k) writes row i of dLq[k] whole: the entries up
// to the diagonal from Lq, the rest as zeros without reading Lq there.  The
// TPU kernel left the upper blocks unwritten (its output was garbage there);
// writing zeros here is what keeps a torch.empty output safe.  g is read from
// device memory (a 0-dim tensor), so the host never waits on the card.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int NTHR = 256;
constexpr int NTHR_FINAL = 1024;

// Sum over the block; the result is valid in thread 0.  Fixed order.
template <typename T, int N>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T red[N / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = threadIdx.x < N / 32 ? red[threadIdx.x] : T(0);
  if (threadIdx.x < 32) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

// Sum of squares of row[0 .. n).  vec: the row starts 16-byte aligned.
__device__ __forceinline__ float row_sumsq(const float* __restrict__ row, int n,
                                           bool vec) {
  float s = 0.f;
  int done = 0;
  if (vec) {
    const int n4 = n / 4;
    const float4* row4 = reinterpret_cast<const float4*>(row);
    for (int c = threadIdx.x; c < n4; c += NTHR) {
      const float4 x = row4[c];
      s += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
    }
    done = n4 * 4;
  }
  for (int j = done + threadIdx.x; j < n; j += NTHR) s += row[j] * row[j];
  return s;
}

__global__ void __launch_bounds__(NTHR)
kl_fwd_kernel(const float* __restrict__ Lq, float* __restrict__ partial, int M,
              bool vec) {
  const int p = blockIdx.x, k = blockIdx.y;
  const int q = M - 1 - p;                 // the paired row (q == p: the middle row)
  const float* Lk = Lq + (size_t)k * M * M;
  float s = row_sumsq(Lk + (size_t)p * M, p + 1, vec);
  if (q != p) s += row_sumsq(Lk + (size_t)q * M, q + 1, vec);
  s = block_sum<float, NTHR>(s);
  if (threadIdx.x == 0) {
    float ld = logf(fabsf(Lk[(size_t)p * M + p]));
    if (q != p) ld += logf(fabsf(Lk[(size_t)q * M + q]));
    const size_t b = (size_t)k * gridDim.x + p;
    partial[2 * b] = s;
    partial[2 * b + 1] = ld;
  }
}

__global__ void __launch_bounds__(NTHR_FINAL)
kl_fwd_final_kernel(const float* __restrict__ partial, int n, float* __restrict__ out) {
  double s = 0.0, ld = 0.0;
  for (int b = threadIdx.x; b < n; b += NTHR_FINAL) {
    s += partial[2 * b];
    ld += partial[2 * b + 1];
  }
  s = block_sum<double, NTHR_FINAL>(s);
  __syncthreads();                         // red[] is reused by the second sum
  ld = block_sum<double, NTHR_FINAL>(ld);
  if (threadIdx.x == 0) {
    out[0] = static_cast<float>(s);
    out[1] = static_cast<float>(ld);
  }
}

__device__ __forceinline__ float bwd_entry(float x, int i, int j, float g) {
  return g * (j == i ? x - 1.f / x : x);
}

__global__ void __launch_bounds__(NTHR)
kl_bwd_kernel(const float* __restrict__ Lq, const float* __restrict__ g,
              float* __restrict__ dLq, int M, bool vec) {
  const int i = blockIdx.x, k = blockIdx.y;
  const size_t off = ((size_t)k * M + i) * M;
  const float* row = Lq + off;
  float* out = dLq + off;
  const float gs = *g;
  if (vec) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (int c = threadIdx.x; c < M / 4; c += NTHR) {
      const int j = 4 * c;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (j + 3 <= i) {                    // wholly on or below the diagonal
        const float4 x = row4[c];
        v[0] = bwd_entry(x.x, i, j, gs);
        v[1] = bwd_entry(x.y, i, j + 1, gs);
        v[2] = bwd_entry(x.z, i, j + 2, gs);
        v[3] = bwd_entry(x.w, i, j + 3, gs);
      } else if (j <= i) {                 // holds the diagonal: read up to it
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j + e <= i) v[e] = bwd_entry(row[j + e], i, j + e, gs);
      }
      out4[c] = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int j = threadIdx.x; j < M; j += NTHR)
      out[j] = j <= i ? bwd_entry(row[j], i, j, gs) : 0.f;
  }
}

// Rows of a [.., M, M] f32 array at p start 16-byte aligned.
bool rows_vec(const void* p, int M) {
  return M % 4 == 0 && reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Lq [K, M, M] f32 (lower triangle read) -> out[0] = sum of squares,
// out[1] = sum of log|diag|.  partial: scratch of 2 * K * ((M + 1) / 2) f32.
extern "C" int mgp_kl_fwd(const void* Lq, void* partial, void* out, int M, int K,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 0 && K > 0) {
    dim3 grid((M + 1) / 2, K);
    kl_fwd_kernel<<<grid, NTHR, 0, s>>>(static_cast<const float*>(Lq),
                                         static_cast<float*>(partial), M,
                                         rows_vec(Lq, M));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    kl_fwd_final_kernel<<<1, NTHR_FINAL, 0, s>>>(
        static_cast<const float*>(partial), K * ((M + 1) / 2),
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// Lq [K, M, M] f32 (lower triangle read), g a device f32 scalar -> dLq [K, M, M]
// f32, exactly 0 above the diagonal.
extern "C" int mgp_kl_bwd(const void* Lq, const void* g, void* dLq, int M, int K,
                          void* stream) {
  if (M > 0 && K > 0) {
    dim3 grid(M, K);
    kl_bwd_kernel<<<grid, NTHR, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(Lq), static_cast<const float*>(g),
        static_cast<float*>(dLq), M, rows_vec(Lq, M) && rows_vec(dLq, M));
  }
  return static_cast<int>(cudaGetLastError());
}
