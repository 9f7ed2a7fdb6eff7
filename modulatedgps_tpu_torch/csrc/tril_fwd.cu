// B[k, n, m'] = sum_{m >= m'} A[m, n] * L[k, m, m']: the forward of the
// conditional's q_sqrt term, B = A^T tril(L_k), from bf16 operands.  Two entry
// points share one kernel, templated on the output type:
//
//   mgp_tril_fwd      B16 = bf16(B)  (the diagonal variance, atl_sq_colsum)
//   mgp_tril_fwd_f32  B   in f32     (the full covariance, atl_matmul)
//
// Replaces modulatedgps_tpu/ops/pallas_tril.py:_k_fwd_b16 (_fwd_pallas_b16)
// and _k_fwd (_fwd_pallas).
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
// hopper.cuh's, shared with tril_bwd.cu): the product is a GEMM with
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
#include "hopper.cuh"

namespace {

using namespace mgp;

constexpr int BN = 128;        // n rows of the output tile (two warpgroups of 64)
constexpr int BP = 256;        // m' columns of the output tile
constexpr int BK = 64;         // m depth per stage
constexpr int STAGES = 4;
constexpr int LBOXES = BP / BOX;                  // L boxes a stage
constexpr int STAGE_BYTES = (2 + LBOXES) * CHUNK; // A: 2 boxes, then L's
constexpr int NACC = BP / 2;                      // fp32 accumulators a thread
constexpr int NCONS = 256;                        // two consumer warpgroups
constexpr int NTHR = NCONS + 32;                  // and one producer warp
constexpr size_t SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;

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

// Output tile t -> (m'-tile p, expert k, n-tile nt): p slowest (the longest
// m-runs first), then the n-tile, then k.
__device__ __forceinline__ void tile_coords(int t, int K, int ntn, int& p, int& k, int& nt) {
  const int per_p = K * ntn;
  p = t / per_p;
  const int o = t - p * per_p;
  nt = o / K;
  k = o - nt * K;
}

template <typename OutT>
__global__ void __launch_bounds__(NTHR, 1)
tril_fwd_kernel(const __grid_constant__ CUtensorMap mapA,
                const __grid_constant__ CUtensorMap mapL, OutT* __restrict__ Bout,
                int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  const int ntn = (N + BN - 1) / BN;
  const int tiles = ((M + BP - 1) / BP) * K * ntn;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);      // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCONS) {              // the producer warp: one lane issues TMA
    if (tid == NCONS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int p, k, nt;
        tile_coords(t, K, ntn, p, k, nt);
        const int p0 = p * BP, n0 = nt * BN;
        for (int m0 = p0; m0 < M; m0 += BK) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          uint8_t* st = smem + stage * STAGE_BYTES;
          tma_load_2d(st, &mapA, &full[stage], n0, m0);
          tma_load_2d(st + CHUNK, &mapA, &full[stage], n0 + BOX, m0);
          for (int h = 0; h < LBOXES; ++h)
            tma_load_3d(st + (2 + h) * CHUNK, &mapL, &full[stage], p0 + h * BOX, m0, k);
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns n-rows n0 + 64 wg .. + 63 of the tile.
  const int wg = tid / 128, lt = tid % 128;
  const int lane = lt % 32, wq = lt / 32;
  const bool vec = (M % 2) == 0;
  int stage = 0;
  uint32_t phase = 0;
  float acc[NACC];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int p, k, nt;
    tile_coords(t, K, ntn, p, k, nt);
    const int p0 = p * BP, n0 = nt * BN;
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    int held = -1;                 // the stage the wgmma group in flight reads
    for (int m0 = p0; m0 < M; m0 += BK) {
      mbar_wait(&full[stage], phase);
      uint8_t* st = smem + stage * STAGE_BYTES;
      if (m0 < p0 + BP) {          // the L tile straddles the diagonal
        zero_upper<BOX, LBOXES, NCONS>(st + 2 * CHUNK, m0 - p0, tid);
        fence_proxy_async();
        asm volatile("bar.sync 1, %0;" ::"n"(NCONS) : "memory");
      }
      const uint32_t a_base = smem_u32(st + wg * CHUNK);
      const uint32_t l_base = smem_u32(st + 2 * CHUNK);
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)   // 16 m-rows = 2 atoms of 8 rows
        wgmma_m64n256(acc, desc_mn_sw128(a_base + kk * 2048, CHUNK, 1024),
                   desc_mn_sw128(l_base + kk * 2048, CHUNK, 1024));
      wgmma_commit();
      // Keep this step's group in flight: wait for the one before it and
      // hand its stage back to the producer.
      wgmma_wait<1>();
      fence_operands(acc);
      if (held >= 0 && lt == 0) mbar_arrive(&empty[held]);
      held = stage;
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (held >= 0 && lt == 0) mbar_arrive(&empty[held]);
    // acc[4 c + 2 h + e] is row 16 wq + lane / 4 + 8 h, column 8 c + 2 (lane
    // % 4) + e of the warpgroup's 64 x BP slab.
    OutT* Bk = Bout + (size_t)k * N * M;
    const int row = n0 + 64 * wg + 16 * wq + lane / 4;
#pragma unroll
    for (int c = 0; c < BP / 8; ++c) {
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
}

template <typename OutT>
int launch(const void* A, const void* L, void* B, int M, int N, int K, int lda, int ldl,
           void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  if (lda % 8 != 0 || ldl % 8 != 0 || lda < N || ldl < M)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mapA, mapL;
  const cuuint64_t dimsA[2] = {(cuuint64_t)lda, (cuuint64_t)M};
  const cuuint64_t strideA[1] = {(cuuint64_t)lda * 2};
  const cuuint64_t dimsL[3] = {(cuuint64_t)ldl, (cuuint64_t)ldl, (cuuint64_t)K};
  const cuuint64_t strideL[2] = {(cuuint64_t)ldl * 2, (cuuint64_t)ldl * ldl * 2};
  if (!encode_bf16(&mapA, 2, A, dimsA, strideA, BOX) ||
      !encode_bf16(&mapL, 3, L, dimsL, strideL, BOX))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      tril_fwd_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = (long long)((M + BP - 1) / BP) * K * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  tril_fwd_kernel<OutT><<<grid, NTHR, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      mapA, mapL, static_cast<OutT*>(B), M, N, K);
  return static_cast<int>(cudaGetLastError());
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
