// The tril forward's product on Hopper, P[k, n, m'] = sum_{m >= m'} A[m, n]
// L[k, m, m'] from bf16 operands with fp32 accumulators, shared by
// tril_fwd.cu (#3/#5, which stores P, and the 3-pass split forward, which
// stores P and squares and sums its rows) and quad.cu (#17, which squares
// and sums its rows); each passes an epilogue that receives one finished
// output tile in registers.  The design is described in tril_fwd.cu.
//
// NPASS = 3 is the 3-pass bf16 split of fp32 operands, A = A_hi + A_lo and
// L = L_hi + L_lo: P = A_hi L_hi + A_lo L_hi + A_hi L_lo, the three m-runs
// of a tile accumulated one after the other into the same fp32 registers
// (A_lo L_lo, ~2^-16 of P, is dropped).  A's map is then 3-D over
// [2, M, lda] (hi, lo) and L's over [2K, ldl, ldl] (hi at k, lo at K + k).
#pragma once

#include "hopper.cuh"

namespace mgp {

constexpr int TP_BN = 128;        // n rows of the output tile (two warpgroups of 64)
constexpr int TP_BP = 256;        // m' columns of the output tile
constexpr int TP_BK = 64;         // m depth per stage
constexpr int TP_STAGES = 4;
constexpr int TP_LBOXES = TP_BP / BOX;                  // L boxes a stage
constexpr int TP_STAGE_BYTES = (2 + TP_LBOXES) * CHUNK; // A: 2 boxes, then L's
constexpr int TP_NACC = TP_BP / 2;                      // fp32 accumulators a thread
constexpr int TP_NCONS = 256;                           // two consumer warpgroups
constexpr int TP_NTHR = TP_NCONS + 32;                  // and one producer warp
constexpr size_t TP_SMEM_BYTES = TP_STAGES * TP_STAGE_BYTES + 1024 + 2 * TP_STAGES * 8;

// Output tile t -> (m'-tile p, expert k, n-tile nt): p slowest (the longest
// m-runs first), then the n-tile, then k.
__device__ __forceinline__ void tile_coords(int t, int K, int ntn, int& p, int& k, int& nt) {
  const int per_p = K * ntn;
  p = t / per_p;
  const int o = t - p * per_p;
  nt = o / K;
  k = o - nt * K;
}

// The kernel body: a persistent CTA of TP_NTHR threads walks the output
// tiles; after each tile's m-run every consumer thread calls
// epi(acc, k, p, n0, wg, lt), where acc[4 c + 2 h + e] is row 16 (lt / 32)
// + (lt % 32) / 4 + 8 h, column 8 c + 2 (lt % 4) + e of warpgroup wg's
// 64 x TP_BP slab of tile (k, m'-tile p, n-rows n0 ..).  Columns m' >= M
// and rows n >= N hold zeros (the operands' padding and TMA's fill).
template <int NPASS = 1, class Epilogue>
__device__ __forceinline__ void tril_product(const CUtensorMap* mapA, const CUtensorMap* mapL,
                                             int M, int N, int K, const Epilogue& epi) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TP_STAGES * TP_STAGE_BYTES);
  uint64_t* empty = full + TP_STAGES;
  const int tid = threadIdx.x;
  const int ntn = (N + TP_BN - 1) / TP_BN;
  const int tiles = ((M + TP_BP - 1) / TP_BP) * K * ntn;

  if (tid == 0) {
    for (int s = 0; s < TP_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);      // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= TP_NCONS) {           // the producer warp: one lane issues TMA
    if (tid == TP_NCONS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int p, k, nt;
        tile_coords(t, K, ntn, p, k, nt);
        const int p0 = p * TP_BP, n0 = nt * TP_BN;
        for (int pass = 0; pass < NPASS; ++pass) {
          const int ja = pass == 1;                  // A_lo on the second pass
          const int kl = k + (pass == 2 ? K : 0);    // L_lo on the third
          for (int m0 = p0; m0 < M; m0 += TP_BK) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], TP_STAGE_BYTES);
            uint8_t* st = smem + stage * TP_STAGE_BYTES;
            if (NPASS == 1) {
              tma_load_2d(st, mapA, &full[stage], n0, m0);
              tma_load_2d(st + CHUNK, mapA, &full[stage], n0 + BOX, m0);
            } else {
              tma_load_3d(st, mapA, &full[stage], n0, m0, ja);
              tma_load_3d(st + CHUNK, mapA, &full[stage], n0 + BOX, m0, ja);
            }
            for (int h = 0; h < TP_LBOXES; ++h)
              tma_load_3d(st + (2 + h) * CHUNK, mapL, &full[stage], p0 + h * BOX, m0, kl);
            if (++stage == TP_STAGES) { stage = 0; phase ^= 1; }
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns n-rows n0 + 64 wg .. + 63 of the tile.
  const int wg = tid / 128, lt = tid % 128;
  int stage = 0;
  uint32_t phase = 0;
  float acc[TP_NACC];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int p, k, nt;
    tile_coords(t, K, ntn, p, k, nt);
    const int p0 = p * TP_BP, n0 = nt * TP_BN;
#pragma unroll
    for (int i = 0; i < TP_NACC; ++i) acc[i] = 0.f;
    int held = -1;                 // the stage the wgmma group in flight reads
    for (int pass = 0; pass < NPASS; ++pass)
    for (int m0 = p0; m0 < M; m0 += TP_BK) {
      mbar_wait(&full[stage], phase);
      uint8_t* st = smem + stage * TP_STAGE_BYTES;
      if (m0 < p0 + TP_BP) {       // the L tile straddles the diagonal
        zero_upper<BOX, TP_LBOXES, TP_NCONS>(st + 2 * CHUNK, m0 - p0, tid);
        fence_proxy_async();
        asm volatile("bar.sync 1, %0;" ::"n"(TP_NCONS) : "memory");
      }
      const uint32_t a_base = smem_u32(st + wg * CHUNK);
      const uint32_t l_base = smem_u32(st + 2 * CHUNK);
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TP_BK / 16; ++kk)   // 16 m-rows = 2 atoms of 8 rows
        wgmma_m64n256(acc, desc_mn_sw128(a_base + kk * 2048, CHUNK, 1024),
                      desc_mn_sw128(l_base + kk * 2048, CHUNK, 1024));
      wgmma_commit();
      // Keep this step's group in flight: wait for the one before it and
      // hand its stage back to the producer.
      wgmma_wait<1>();
      fence_operands(acc);
      if (held >= 0 && lt == 0) mbar_arrive(&empty[held]);
      held = stage;
      if (++stage == TP_STAGES) { stage = 0; phase ^= 1; }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (held >= 0 && lt == 0) mbar_arrive(&empty[held]);
    epi(acc, k, p, n0, wg, lt);
  }
}

// Launch `kernel(mapA, mapL, args...)` on a persistent grid (one CTA per SM,
// at most one per tile) over A [M, lda] and L [K, ldl, ldl] bf16, lda and
// ldl multiples of 8 with lda >= N and ldl >= M; for NPASS = 3 over A
// [2, M, lda] and L [2K, ldl, ldl] (the hi parts, then the lo parts).
template <int NPASS = 1, typename... KArgs, typename... Args>
int launch_tril_product(void (*kernel)(CUtensorMap, CUtensorMap, KArgs...), const void* A,
                        const void* L, int M, int N, int K, int lda, int ldl, void* stream,
                        Args... args) {
  if (lda % 8 != 0 || ldl % 8 != 0 || lda < N || ldl < M)
    return static_cast<int>(cudaErrorInvalidValue);
  const int planes = NPASS == 1 ? 1 : 2;
  CUtensorMap mapA, mapL;
  const cuuint64_t dimsA[3] = {(cuuint64_t)lda, (cuuint64_t)M, (cuuint64_t)planes};
  const cuuint64_t strideA[2] = {(cuuint64_t)lda * 2, (cuuint64_t)lda * M * 2};
  const cuuint64_t dimsL[3] = {(cuuint64_t)ldl, (cuuint64_t)ldl, (cuuint64_t)K * planes};
  const cuuint64_t strideL[2] = {(cuuint64_t)ldl * 2, (cuuint64_t)ldl * ldl * 2};
  if (!encode_bf16(&mapA, NPASS == 1 ? 2 : 3, A, dimsA, strideA, BOX) ||
      !encode_bf16(&mapL, 3, L, dimsL, strideL, BOX))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TP_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles =
      (long long)((M + TP_BP - 1) / TP_BP) * K * ((N + TP_BN - 1) / TP_BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, TP_NTHR, TP_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(mapA, mapL,
                                                                              args...);
  return static_cast<int>(cudaGetLastError());
}

// An epilogue: each thread squares its fp32 accumulators and sums them
// along m' for each of its two rows, the four threads of a quad combine
// theirs with two shuffles, and one lane writes the tile's row sum to part
// [K, P, N], P = ceil(M / TP_BP); partial_sums_kernel then adds each (k, n)'s
// partial sums over the m'-tiles in order.  No atomics: two runs give the
// same bits.
struct RowSquareSums {
  float* part;   // [K, P, N]
  int N, P;
  __device__ __forceinline__ void operator()(float (&acc)[TP_NACC], int k, int p, int n0,
                                             int wg, int lt) const {
    const int lane = lt % 32, wq = lt / 32;
    const int row = n0 + 64 * wg + 16 * wq + lane / 4;
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < TP_BP / 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = acc[4 * c + 2 * h + e];
          s[h] = fmaf(v, v, s[h]);
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
      const int n = row + 8 * h;
      if (lane % 4 == 0 && n < N) part[((size_t)k * P + p) * N + n] = s[h];
    }
  }
};

// out[k, n] = sum_p part[k, p, n], p in order.
static __global__ void partial_sums_kernel(const float* __restrict__ part,
                                           float* __restrict__ out, int K, int P, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= K * N) return;
  const int k = i / N, n = i - k * N;
  const float* src = part + (size_t)k * P * N + n;
  float v = src[0];
  for (int p = 1; p < P; ++p) v += src[(size_t)p * N];
  out[i] = v;
}

inline int launch_partial_sums(const float* part, float* out, int K, int M, int N,
                               void* stream) {
  const int n = K * N;
  partial_sums_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      part, out, K, (M + TP_BP - 1) / TP_BP, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mgp
