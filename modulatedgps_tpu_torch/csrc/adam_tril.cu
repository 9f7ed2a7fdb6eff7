// One Adam step with optax's arithmetic over the lower triangle of [K, M, M]
// f32 leaves, in place:
//
//   m' = b1 m + (1 - b1) g
//   v' = b2 v + (1 - b2) g g
//   p' = p - lr (m' c1) / (sqrt(v' c2) + eps),   c = 1 / (1 - b^t).
//
// Replaces modulatedgps_tpu/training/fused_adam.py:_k_adam (_pallas_adam).
//
// Bound on the H100: device memory.  Each lower-triangle entry reads p, g, m, v
// and writes p, m, v: 7 x 2.7e8 B per [8, 4096, 4096] leaf, ~0.56 ms at
// 3.35 TB/s, against ~10 operations an entry.  Design: one block per pair of
// rows (r, M-1-r) of slice k, so every block has M+1 entries, streams each
// row's entries up to the diagonal with 16-byte loads and stores and a scalar
// tail; the strictly-upper entries are neither read nor written, so
// they keep their bits (the TPU kernel aliased its outputs onto p, m and v
// for the same reason).  The constants and the bias corrections come from the
// caller as f32, and every operation is rounded on its own (no contraction
// into FMAs), in the order of the plain version and of optax.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int NTHR = 256;

struct AdamArgs {
  float b1, omb1, b2, omb2, lr, c1, c2, eps;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const AdamArgs& a) {
  const float m2 = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.omb1, g));
  const float v2 = __fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(__fmul_rn(a.omb2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v2, a.c2)), a.eps);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(a.lr, __fmul_rn(m2, a.c1)), den));
  m = m2;
  v = v2;
}

// Row i of one [M, M] slice (offset off), its first i+1 entries.
__device__ __forceinline__ void update_row(float* __restrict__ p,
                                           const float* __restrict__ g,
                                           float* __restrict__ m,
                                           float* __restrict__ v, size_t off,
                                           int n, bool vec, const AdamArgs& a) {
  int done = 0;
  if (vec) {
    const int n4 = n / 4;
    float4* p4 = reinterpret_cast<float4*>(p + off);
    const float4* g4 = reinterpret_cast<const float4*>(g + off);
    float4* m4 = reinterpret_cast<float4*>(m + off);
    float4* v4 = reinterpret_cast<float4*>(v + off);
    for (int c = threadIdx.x; c < n4; c += NTHR) {
      float4 pp = p4[c], mm = m4[c], vv = v4[c];
      const float4 gg = g4[c];
      update(pp.x, gg.x, mm.x, vv.x, a);
      update(pp.y, gg.y, mm.y, vv.y, a);
      update(pp.z, gg.z, mm.z, vv.z, a);
      update(pp.w, gg.w, mm.w, vv.w, a);
      p4[c] = pp;
      m4[c] = mm;
      v4[c] = vv;
    }
    done = n4 * 4;
  }
  for (int j = done + threadIdx.x; j < n; j += NTHR) {
    float pp = p[off + j], mm = m[off + j], vv = v[off + j];
    update(pp, g[off + j], mm, vv, a);
    p[off + j] = pp;
    m[off + j] = mm;
    v[off + j] = vv;
  }
}

// Block (r, k) updates rows r and M-1-r of slice k (M+1 entries: balanced).
__global__ void __launch_bounds__(NTHR)
adam_tril_kernel(float* __restrict__ p, const float* __restrict__ g,
                 float* __restrict__ m, float* __restrict__ v, int M, bool vec,
                 AdamArgs a) {
  const int r = blockIdx.x, k = blockIdx.y;
  const int q = M - 1 - r;
  update_row(p, g, m, v, ((size_t)k * M + r) * M, r + 1, vec, a);
  if (q != r) update_row(p, g, m, v, ((size_t)k * M + q) * M, q + 1, vec, a);
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// p, g, m, v [K, M, M] f32, contiguous; p, m, v updated in place on and below
// the diagonal.  omb1 = 1 - b1 and omb2 = 1 - b2 are rounded by the caller.
extern "C" int mgp_adam_tril(void* p, const void* g, void* m, void* v, int M, int K,
                             float b1, float omb1, float b2, float omb2, float lr,
                             float c1, float c2, float eps, void* stream) {
  if (M > 0 && K > 0) {
    const bool vec = M % 4 == 0 && aligned16(p) && aligned16(g) && aligned16(m) &&
                     aligned16(v);
    dim3 grid((M + 1) / 2, K);
    adam_tril_kernel<<<grid, NTHR, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(p), static_cast<const float*>(g), static_cast<float*>(m),
        static_cast<float*>(v), M, vec, AdamArgs{b1, omb1, b2, omb2, lr, c1, c2, eps});
  }
  return static_cast<int>(cudaGetLastError());
}
