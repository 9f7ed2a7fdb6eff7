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
// stores, no shared-memory staging.  No chunk above the diagonal is read; the
// few entries past the diagonal in the chunk that holds it are dropped.
//
// Forward design: a persistent grid of KL_CTAS_PER_SM 256-thread CTAs an SM,
// each warp a share of the work items.  An item is the row pair (p, M-1-p) of
// one Lq[k] up to the diagonal: the two rows hold M+1 entries, so every item
// is the same number of 16-byte chunks (give or take one) and each warp takes
// every W-th item (W warps in the grid).  A lane loads 8 chunks of an item
// before it adds any (eight 16-byte loads in flight), squares and adds them
// in fp32, and adds each batch into a double.  The lane whose chunk holds a
// row's diagonal drops the entries past it (loaded with the chunk, never
// added) and takes the log from the value it loaded: no thread reads the
// diagonal again.  Each CTA adds its warps' sums in order into one partial;
// the last CTA to finish (a counter the launcher zeroes first) adds the
// partials in order, in double.  No float atomics, so the result is the
// same bits on every run on a card, and a resumed training run reproduces
// its losses.
//
// Backward design: block (i, k) writes row i of dLq[k] whole: the entries up
// to the diagonal from Lq, the rest as zeros without reading Lq there.  The
// TPU kernel left the upper blocks unwritten (its output was garbage there);
// writing zeros here is what keeps a torch.empty output safe.  g is read from
// device memory (a 0-dim tensor), so the host never waits on the card.
#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int NTHR = 256;
constexpr int KL_CTAS_PER_SM = 4;   // the forward's persistent grid
constexpr int KL_UNROLL = 8;        // 16-byte loads a lane keeps in flight

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

// One item's sums for this lane: rows p and q = M-1-p of Lk up to the
// diagonal, in chunks of CW floats (4: the rows start 16-byte aligned; 1
// otherwise).  Chunk c < n1 is row p's chunk c, the others row q's.
template <int CW>
__device__ __forceinline__ void item_sums(const float* __restrict__ Lk, int M,
                                          int p, int lane, double& s,
                                          double& ld) {
  using V = typename std::conditional<CW == 4, float4, float>::type;
  const int q = M - 1 - p;
  const int n1 = p / CW + 1;
  const int n = n1 + (q != p ? q / CW + 1 : 0);
  for (int c0 = lane; c0 < n; c0 += 32 * KL_UNROLL) {
    float v[KL_UNROLL][CW];
#pragma unroll
    for (int u = 0; u < KL_UNROLL; ++u) {
      const int c = c0 + 32 * u;
      const int row = c < n1 ? p : q;
      const int cc = c < n1 ? c : c - n1;
      V x{};
      if (c < n) x = reinterpret_cast<const V*>(Lk + (size_t)row * M)[cc];
      memcpy(v[u], &x, sizeof(V));
    }
    float part = 0.f;
#pragma unroll
    for (int u = 0; u < KL_UNROLL; ++u) {
      const int c = c0 + 32 * u;
      const int row = c < n1 ? p : q;
      const int cc = c < n1 ? c : c - n1;
      if (c < n && cc == row / CW) {        // the chunk holding the diagonal
        const int e = row - cc * CW;
#pragma unroll
        for (int t = 0; t < CW; ++t) {
          if (t == e) ld += logf(fabsf(v[u][t]));
          if (t > e) v[u][t] = 0.f;
        }
      }
#pragma unroll
      for (int t = 0; t < CW; ++t) part = fmaf(v[u][t], v[u][t], part);
    }
    s += part;
  }
}

template <int CW>
__global__ void __launch_bounds__(NTHR, KL_CTAS_PER_SM)
kl_fwd_kernel(const float* __restrict__ Lq, double* partial, float* __restrict__ out,
              int M, int K) {
  __shared__ double red[2][NTHR / 32];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int P = (M + 1) / 2;                // row pairs of one Lq[k]
  const long long items = (long long)K * P;
  const int W = gridDim.x * (NTHR / 32);
  double s = 0.0, ld = 0.0;
  for (long long it = (long long)blockIdx.x * (NTHR / 32) + warp; it < items;
       it += W) {
    const int k = static_cast<int>(it / P), p = static_cast<int>(it % P);
    item_sums<CW>(Lq + (size_t)k * M * M, M, p, lane, s, ld);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ld += __shfl_xor_sync(0xffffffffu, ld, o);
  }
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = ld;
  }
  __syncthreads();
  unsigned int* counter = reinterpret_cast<unsigned int*>(partial + 2 * gridDim.x);
  if (threadIdx.x == 0) {
    double cs = 0.0, cl = 0.0;
#pragma unroll
    for (int w = 0; w < NTHR / 32; ++w) {
      cs += red[0][w];
      cl += red[1][w];
    }
    partial[2 * blockIdx.x] = cs;
    partial[2 * blockIdx.x + 1] = cl;
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // The last CTA: the CTAs' partials in order, a lane a stride of them.
  __threadfence();
  const volatile double* vp = partial;
  double ts = 0.0, tl = 0.0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += NTHR) {
    ts += vp[2 * b];
    tl += vp[2 * b + 1];
  }
  ts = block_sum<double, NTHR>(ts);
  __syncthreads();                          // red[] is reused by the second sum
  tl = block_sum<double, NTHR>(tl);
  if (threadIdx.x == 0) {
    out[0] = static_cast<float>(ts);
    out[1] = static_cast<float>(tl);
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

// The forward's scratch on card `device`: writes to the int at `slots` its
// length in f64, two partials for each CTA of the persistent grid (the SMs
// times KL_CTAS_PER_SM) and the counter's slot.
extern "C" int mgp_kl_fwd_scratch(int device, void* slots) {
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *static_cast<int*>(slots) = 2 * sms * KL_CTAS_PER_SM + 1;
  return 0;
}

// Lq [K, M, M] f32 (lower triangle read) -> out[0] = sum of squares,
// out[1] = sum of log|diag|.  partial: the scratch mgp_kl_fwd_scratch sizes,
// `slots` f64; the grid is its (slots - 1) / 2 CTAs, and the last slot holds
// the counter, zeroed here.
extern "C" int mgp_kl_fwd(const void* Lq, void* partial, void* out, int M, int K,
                          int slots, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (slots - 1) / 2;
  if (M > 0 && K > 0 && grid > 0) {
    double* part = static_cast<double*>(partial);
    const cudaError_t err =
        cudaMemsetAsync(part + 2 * grid, 0, sizeof(unsigned int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (rows_vec(Lq, M))
      kl_fwd_kernel<4><<<grid, NTHR, 0, s>>>(static_cast<const float*>(Lq), part,
                                             static_cast<float*>(out), M, K);
    else
      kl_fwd_kernel<1><<<grid, NTHR, 0, s>>>(static_cast<const float*>(Lq), part,
                                             static_cast<float*>(out), M, K);
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
