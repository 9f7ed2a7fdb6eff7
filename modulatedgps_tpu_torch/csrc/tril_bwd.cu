// Backward of B = A^T tril L_k, the conditional's q_sqrt term:
//
//   dL[k, m, m'] = sum_n A16[m, n] W_k[n, m']          (m >= m', else 0)
//   dA[m, n]     = sum_k sum_{m' <= m} L16[k, m, m'] W_k[n, m']
//
// with W read in one of two ways (the kernels are templated on it):
//
//   scaled: the square-sum extra[k, n] = sum_m' B16[k, n, m']^2 with
//     B16 = bf16(B), whose cotangent scaling is fused into the kernels,
//     W_k[n, m'] = bf16( f32(B16[k, n, m']) * G[k, n] ),  G = 2 * dextra;
//     replaces modulatedgps_tpu/ops/pallas_tril.py:_k_dl_g (_dl_pallas_g)
//     and _k_da_g (_da_pallas_g);
//   direct: W16 = bf16(dB), the cotangent of the f32 B of the joint
//     covariance, read from memory; replaces pallas_tril.py:_k_dl
//     (_dl_pallas) and _k_da (_da_pallas), atl_matmul's backward.
//
// Bound on the H100: tensor-core math.  At M=4096, N=8192, K=8 each kernel
// does the lower triangle's K*N*M^2/2 = 5.5e11 multiply-adds (1.1 ms at the
// 989 TFLOP/s bf16 peak) against ~1 GB of compulsory traffic, so both run
// on bf16 wgmma with fp32 accumulators held over the whole contraction (the
// TPU's precision class: bf16 operands, f32 accumulation; never bf16
// accumulation or TF32).
//
// Design (Hopper; the plumbing is hopper.cuh's, shared with tril_fwd.cu):
// a persistent grid of one CTA per SM; per CTA one thread of a producer
// warpgroup issues TMA loads (128-byte swizzle) into a ring of four 48 KB
// stages with full / empty mbarriers, and two consumer warpgroups run
// wgmma over each stage.  The producer's warpgroup hands registers to the
// consumers (setmaxnreg 40 / 232): at the 168 a thread of 384 gets at
// launch, ptxas serialized every wgmma.
//
// An output tile is 256 (m) x 128 (n for dA, m' for dL), computed
// transposed: W is wgmma's A operand, from registers, and the 256-row L
// (dA) or A16 (dL) box is B, read from shared memory, K-major.  Each
// warpgroup loads its 64 rows of the stage's W box with ldmatrix
// (transposed for dL, whose W box has n as rows), forms W there and runs
// m64n256k16 over it.  W is formed on chip: the producer also loads the
// stage's slice of G (f32, no swizzle), and each value becomes
// bf16(f32(b) * G[k, n]) in registers (the TPU kernels' rounding order: an
// f32 product, one bf16 rounding), so no W array reaches device memory (the
// direct form takes W16 as loaded).  W then costs shared memory one TMA
// write and one read; scaled in place in shared memory before wgmma read
// it, it cost a read and a write more, and the scaled kernels ran 11-20%
// slower on an H100 (PERF.md §6).  The fragments are loaded only
// after the previous group's wait: loaded while it ran, into registers of
// their own, they gave wrong sums, the registers it still read being
// reused.
//
// tril_da: output [M, N], contraction over (k, m').  L_k [M, M] and W_k
//   [N, M] are both m'-contiguous: K-major operands as they lie in memory.
//   The run of the tile at m-tile m0 is, for each k, the 64-wide m'-stages
//   up to its diagonal, K (m0 + 256) / 64 in all; the stages that straddle
//   the diagonal get L's entries with m < m' overwritten with 0 in shared
//   memory (a store, never a multiply: NaN * 0 is NaN), then a proxy fence
//   and a barrier of the two warpgroups.  Tiles are walked longest run
//   first, in a snake over the CTAs (CTA b takes tile b of the first wave,
//   G-1-b of the second, ...).
// tril_dl: output [K, M, M], contraction over all n.  Every tile on or
//   below the diagonal runs the same N / 64 stages; the tiles above it are
//   written as exact zeros after them, and the diagonal tiles write 0 where
//   m < m' in the epilogue, so dL comes out exactly lower-triangular with
//   no `tril` pass afterwards.
//
// Alignment rule: TMA needs 16-byte row strides, so the wrapper hands in
// A16 and G with ldn = N rounded up to a multiple of 8, and L16 and B16 /
// W16 with ldm = M rounded up to a multiple of 8, padded with zeros where
// N or M is not such a multiple.  Reads past the arrays are zero-filled by
// TMA; the kernels store m < M, m' < M, n < N only.
#include "hopper.cuh"

namespace {

using namespace mgp;

constexpr int STAGES = 4;
constexpr int NCONS = 256;                 // two consumer warpgroups
constexpr int NTHR = NCONS + 128;          // and the producer's warpgroup
constexpr int BM = 256;                    // m rows of a tile: the L / A box
constexpr int BW = 128;                    // W rows of a tile: 64 a warpgroup
constexpr int XBYTES = BM * 128;           // the L / A box (BM rows of 64)
constexpr int STAGE_BYTES = XBYTES + BW * 128;   // then W's
constexpr int GSLOT = BW * 4;              // a stage's G slice (<= BW f32)
constexpr size_t SMEM_BYTES = STAGES * (STAGE_BYTES + GSLOT) + 1024 + 2 * STAGES * 8;

// bf16(f32(v) * g) of a pair of bf16, scaled by (g0, g1).
__device__ __forceinline__ uint32_t scale2(uint32_t v, float g0, float g1) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  const float2 f = __bfloat1622float2(h);
  h = __floats2bfloat162_rn(f.x * g0, f.y * g1);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The stage ring: full / empty barriers, the stage and its phase.
struct Ring {
  uint8_t* smem;
  uint64_t* full;
  uint64_t* empty;
  float* g;
  int stage = 0;
  uint32_t phase = 0;
  __device__ uint8_t* st() const { return smem + stage * STAGE_BYTES; }
  __device__ float* gs() const { return g + stage * (GSLOT / 4); }
  __device__ void next() {
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }
};

__device__ __forceinline__ Ring ring_init(uint8_t* smem_raw) {
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  Ring r;
  r.smem = smem;
  r.g = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);
  r.full = reinterpret_cast<uint64_t*>(smem + STAGES * (STAGE_BYTES + GSLOT));
  r.empty = r.full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], 2);   // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The producer's side of a stage: wait for it to be free, then expect its
// bytes on its full barrier (the TMA loads follow).
__device__ __forceinline__ uint64_t* stage_fill(Ring& ring, uint32_t bytes) {
  mbar_wait(&ring.empty[ring.stage], ring.phase ^ 1);
  uint64_t* bar = &ring.full[ring.stage];
  mbar_expect_tx(bar, bytes);
  return bar;
}

// The consumers' side: wait for the stage to land ...
__device__ __forceinline__ uint8_t* stage_wait(const Ring& ring) {
  mbar_wait(&ring.full[ring.stage], ring.phase);
  return ring.st();
}

// ... after zeroing L's upper entries in it, fence them to wgmma and sync
// the two warpgroups ...
__device__ __forceinline__ void stage_edited() {
  fence_proxy_async();
  asm volatile("bar.sync 1, %0;" ::"n"(NCONS) : "memory");
}

// ... wait for the group in flight and hand its stage back (only then may
// the fragments be loaded) ...
__device__ __forceinline__ void stage_drain(Ring& ring, int& held, float (&acc)[128], int lt) {
  wgmma_wait<0>();
  fence_operands(acc);
  if (held >= 0 && lt == 0) mbar_arrive(&ring.empty[held]);
  held = -1;
}

// ... and issue the stage's group from the fragments `a` over the B box at
// `bbase`, keeping it in flight.
__device__ __forceinline__ void stage_issue(Ring& ring, int& held, float (&acc)[128],
                                            uint32_t (&a)[4][4], uint32_t bbase) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BOX / 16; ++kk)
    wgmma_m64n256_rs(acc, a[kk], desc_k_sw128(bbase + kk * 32));
  wgmma_commit();
  held = ring.stage;
  ring.next();
}

// Tile `it` of CTA b of G: a snake, so a CTA given a long tile in one wave
// gets a short one in the next.
__device__ __forceinline__ int snake(int it) {
  return it * gridDim.x + ((it & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// Writes a warpgroup's transposed 64 x 256 slab: acc[4 c + 2 h + e] is the
// output's column c0 + 64 wg + 16 wq + lane / 4 + 8 h and row r0 + 8 c + 2
// (lane % 4) + e of out [rows, cols]; lower: 0 where row < column.
__device__ __forceinline__ void store_tile(float (&acc)[128], float* out, int rows, int cols,
                                           int r0, int c0, bool lower, int wg, int lt) {
  const int lane = lt % 32, wq = lt / 32;
  const int cb = c0 + 64 * wg + 16 * wq + lane / 4;
#pragma unroll
  for (int c = 0; c < 32; ++c)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = r0 + 8 * c + 2 * (lane % 4) + e;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = cb + 8 * h;
        if (row < rows && col < cols)
          out[(size_t)row * cols + col] = (lower && row < col) ? 0.f : acc[4 * c + 2 * h + e];
      }
    }
}

// dA tile t -> its first row: the m-tiles from the bottom (the longest
// runs first), the n-tiles of one m-tile adjacent.
__device__ __forceinline__ int da_m0(int t, int mtc, int ntc) {
  return (mtc - 1 - t / ntc) * BM;
}

template <bool kScaled>
__global__ void __launch_bounds__(NTHR, 1)
tril_da_kernel(const __grid_constant__ CUtensorMap mapL,
               const __grid_constant__ CUtensorMap mapW,
               const __grid_constant__ CUtensorMap mapG, float* __restrict__ dA, int M,
               int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  Ring ring = ring_init(smem_raw);
  const int tid = threadIdx.x;
  const int mtc = (M + BM - 1) / BM, ntc = (N + BW - 1) / BW;
  const int tiles = mtc * ntc;

  if (tid >= NCONS) {              // the producer: one thread issues TMA
    producer_regs();
    if (tid == NCONS) {
      for (int it = 0, t; (t = snake(it)) < tiles; ++it) {
        const int m0 = da_m0(t, mtc, ntc), n0 = (t % ntc) * BW;
        const int per_k = (min(m0 + BM, M) + BOX - 1) / BOX;
        for (int k = 0; k < K; ++k)
          for (int q = 0; q < per_k; ++q) {
            uint64_t* bar = stage_fill(ring, STAGE_BYTES + (kScaled ? BW * 4 : 0));
            tma_load_3d(ring.st(), &mapL, bar, q * BOX, m0, k);
            tma_load_3d(ring.st() + XBYTES, &mapW, bar, q * BOX, n0, k);
            if (kScaled) tma_load_2d(ring.gs(), &mapG, bar, n0, k);
            ring.next();
          }
      }
    }
  } else {
    consumer_regs();
    const int wg = tid / 128, lt = tid % 128, lane = lt % 32, wq = lt / 32;
    // This lane's ldmatrix row of the W box (matrix lane / 8: rows + 8 for
    // odd, columns + 8 for the upper two) and the n of its fragment's a0
    // and a2 (a1 and a3: + 8).
    const int wrow = 64 * wg + 16 * wq + 8 * ((lane / 8) & 1) + lane % 8;
    const int frow = 64 * wg + 16 * wq + lane / 4;
    float acc[128];
    uint32_t a[4][4];
    int held = -1;
    for (int it = 0, t; (t = snake(it)) < tiles; ++it) {
      const int m0 = da_m0(t, mtc, ntc), n0 = (t % ntc) * BW;
      const int per_k = (min(m0 + BM, M) + BOX - 1) / BOX;   // m'-stages to the diagonal
#pragma unroll
      for (int j = 0; j < 128; ++j) acc[j] = 0.f;
      for (int k = 0; k < K; ++k)
        for (int q = 0; q < per_k; ++q) {
          const int p = q * BOX;
          uint8_t* st = stage_wait(ring);
          if (p + BOX - 1 > m0) {           // L's box straddles the diagonal
            zero_upper<BM, 1, NCONS>(st, m0 - p, tid);
            stage_edited();
          }
          const uint32_t base = smem_u32(st);
          const float glo = kScaled ? ring.gs()[frow] : 1.f;
          const float ghi = kScaled ? ring.gs()[frow + 8] : 1.f;
          stage_drain(ring, held, acc, lt);
#pragma unroll
          for (int kk = 0; kk < BOX / 16; ++kk) {
            const int g = 2 * kk + lane / 16;
            ldsm_x4(base + XBYTES + wrow * 128 + ((g ^ (wrow & 7)) << 4), a[kk]);
            if (kScaled) {
              a[kk][0] = scale2(a[kk][0], glo, glo);
              a[kk][1] = scale2(a[kk][1], ghi, ghi);
              a[kk][2] = scale2(a[kk][2], glo, glo);
              a[kk][3] = scale2(a[kk][3], ghi, ghi);
            }
          }
          stage_issue(ring, held, acc, a, base);
        }
      stage_drain(ring, held, acc, lt);
      store_tile(acc, dA, M, N, m0, n0, false, wg, lt);
    }
  }
}

// dL tile t -> (k, m0, p0): first the tiles on or below the diagonal of
// every k, then those above it; returns whether t is below.
__device__ __forceinline__ bool dl_coords(int t, int M, int K, int lower, int& k, int& m0,
                                          int& p0) {
  const int mtc = (M + BM - 1) / BM, ntc = (M + BW - 1) / BW;
  const bool low = t < K * lower;
  const int per_k = low ? lower : mtc * ntc - lower;
  if (!low) t -= K * lower;
  k = t / per_k;
  int o = t - k * per_k;
  m0 = p0 = 0;
  for (int i = 0; i < mtc; ++i) {
    const int jmax = min(ntc - 1, (min(M, (i + 1) * BM) - 1) / BW);
    const int count = low ? jmax + 1 : ntc - 1 - jmax;
    if (o < count) {
      m0 = i * BM;
      p0 = (low ? o : jmax + 1 + o) * BW;
      break;
    }
    o -= count;
  }
  return low;
}

template <bool kScaled>
__global__ void __launch_bounds__(NTHR, 1)
tril_dl_kernel(const __grid_constant__ CUtensorMap mapA,
               const __grid_constant__ CUtensorMap mapW,
               const __grid_constant__ CUtensorMap mapG, float* __restrict__ dL, int M,
               int N, int K, int lower) {
  extern __shared__ uint8_t smem_raw[];
  Ring ring = ring_init(smem_raw);
  const int tid = threadIdx.x;
  const int tiles = K * ((M + BM - 1) / BM) * ((M + BW - 1) / BW);
  const int stages = (N + BOX - 1) / BOX;

  if (tid >= NCONS) {              // the producer: one thread issues TMA
    producer_regs();
    if (tid == NCONS) {
      for (int it = 0, t; (t = snake(it)) < tiles; ++it) {
        int k, m0, p0;
        if (!dl_coords(t, M, K, lower, k, m0, p0)) continue;
        for (int s = 0; s < stages; ++s) {
          uint64_t* bar = stage_fill(ring, STAGE_BYTES + (kScaled ? BOX * 4 : 0));
          tma_load_2d(ring.st(), &mapA, bar, s * BOX, m0);
#pragma unroll
          for (int h = 0; h < BW / BOX; ++h)
            tma_load_3d(ring.st() + XBYTES + h * CHUNK, &mapW, bar, p0 + h * BOX, s * BOX, k);
          if (kScaled) tma_load_2d(ring.gs(), &mapG, bar, s * BOX, k);
          ring.next();
        }
      }
    }
  } else {
    consumer_regs();
    const int wg = tid / 128, lt = tid % 128, lane = lt % 32, wq = lt / 32;
    // W's box wg holds this warpgroup's 64 m' as columns and n as rows, so
    // its fragments come transposed: this lane gives row n = 16 kk + 8
    // (lane / 16) + lane % 8 and granule 2 wq + (lane / 8) % 2 of the box;
    // its a0 holds n = 16 kk + 2 (lane % 4) + {0, 1}, a2 those + 8 (a1, a3
    // alike).
    const int nrow = 8 * (lane / 16) + lane % 8;
    const int gran = 2 * wq + (lane / 8) % 2;
    const int fn = 2 * (lane % 4);
    float acc[128];
    uint32_t a[4][4];
    int held = -1;
    for (int it = 0, t; (t = snake(it)) < tiles; ++it) {
      int k, m0, p0;
      const bool low = dl_coords(t, M, K, lower, k, m0, p0);
#pragma unroll
      for (int j = 0; j < 128; ++j) acc[j] = 0.f;   // a tile above the diagonal stores these
      if (low) {
        for (int s = 0; s < stages; ++s) {
          const uint32_t base = smem_u32(stage_wait(ring));
          const float* gs = ring.gs();
          stage_drain(ring, held, acc, lt);
#pragma unroll
          for (int kk = 0; kk < BOX / 16; ++kk) {
            const int n = 16 * kk + nrow;
            ldsm_x4_trans(base + XBYTES + wg * CHUNK + n * 128 + ((gran ^ (n & 7)) << 4),
                          a[kk]);
            if (kScaled) {
              const float2 g0 = *reinterpret_cast<const float2*>(gs + 16 * kk + fn);
              const float2 g8 = *reinterpret_cast<const float2*>(gs + 16 * kk + fn + 8);
              a[kk][0] = scale2(a[kk][0], g0.x, g0.y);
              a[kk][1] = scale2(a[kk][1], g0.x, g0.y);
              a[kk][2] = scale2(a[kk][2], g8.x, g8.y);
              a[kk][3] = scale2(a[kk][3], g8.x, g8.y);
            }
          }
          stage_issue(ring, held, acc, a, base);
        }
        stage_drain(ring, held, acc, lt);
      }
      store_tile(acc, dL + (size_t)k * M * M, M, M, m0, p0, true, wg, lt);
    }
  }
}

// W [K, N, ldm] bf16 as a 3-D map read in boxes of `rows` n-rows of 64 m'.
bool encode_w(CUtensorMap* map, const void* W, int N, int K, int ldm, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)ldm, (cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t strides[2] = {(cuuint64_t)ldm * 2, (cuuint64_t)N * ldm * 2};
  return encode_bf16(map, 3, W, dims, strides, rows);
}

// G [K, ldn] f32 read in slices of `box` (no swizzle); the direct forms,
// which read no G, get W's map in its place.
bool encode_g(CUtensorMap* map, const void* G, int K, int ldn, int box) {
  const cuuint64_t dims[2] = {(cuuint64_t)ldn, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)ldn * 4};
  const cuuint32_t boxd[2] = {(cuuint32_t)box, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, G, dims, strides, boxd,
                CU_TENSOR_MAP_SWIZZLE_NONE);
}

// A persistent launch of `kernel` over `tiles` tiles.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, long long tiles, void* stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, NTHR, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int M, int N, int ldn, int ldm) {
  return ldn % 8 != 0 || ldm % 8 != 0 || ldn < N || ldm < M;
}

template <bool kScaled>
int launch_da(const void* L, const void* W, const void* G, void* dA, int M, int N, int K,
              int ldm, int ldn, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  if (bad_args(M, N, ldn, ldm)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mapL, mapW, mapG;
  const cuuint64_t dimsL[3] = {(cuuint64_t)ldm, (cuuint64_t)ldm, (cuuint64_t)K};
  const cuuint64_t strideL[2] = {(cuuint64_t)ldm * 2, (cuuint64_t)ldm * ldm * 2};
  if (!encode_bf16(&mapL, 3, L, dimsL, strideL, BM) || !encode_w(&mapW, W, N, K, ldm, BW) ||
      (kScaled ? !encode_g(&mapG, G, K, ldn, BW) : !encode_w(&mapG, W, N, K, ldm, BW)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BW - 1) / BW);
  return launch(tril_da_kernel<kScaled>, tiles, stream, mapL, mapW, mapG,
                static_cast<float*>(dA), M, N, K);
}

template <bool kScaled>
int launch_dl(const void* A, const void* W, const void* G, void* dL, int M, int N, int K,
              int ldn, int ldm, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  if (bad_args(M, N, ldn, ldm)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mapA, mapW, mapG;
  const cuuint64_t dimsA[2] = {(cuuint64_t)ldn, (cuuint64_t)M};
  const cuuint64_t strideA[1] = {(cuuint64_t)ldn * 2};
  if (!encode_bf16(&mapA, 2, A, dimsA, strideA, BM) || !encode_w(&mapW, W, N, K, ldm, BOX) ||
      (kScaled ? !encode_g(&mapG, G, K, ldn, BOX) : !encode_w(&mapG, W, N, K, ldm, BOX)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mtc = (M + BM - 1) / BM, ntc = (M + BW - 1) / BW;
  int lower = 0;   // tiles on or below the diagonal of one k
  for (int i = 0; i < mtc; ++i) {
    const int jmax = (((i + 1) * BM < M ? (i + 1) * BM : M) - 1) / BW;
    lower += (jmax < ntc - 1 ? jmax : ntc - 1) + 1;
  }
  return launch(tril_dl_kernel<kScaled>, (long long)K * mtc * ntc, stream, mapA, mapW, mapG,
                static_cast<float*>(dL), M, N, K, lower);
}

}  // namespace

// ldn and ldm are N and M rounded up to multiples of 8 (the row strides).

// A16 [M, ldn] bf16 (columns past N zero), B16 [K, N, ldm] bf16 (columns
// past M zero), G [K, ldn] f32 -> dL [K, M, M] f32, exactly lower-triangular.
extern "C" int mgp_tril_dl(const void* A, const void* B, const void* G, void* dL, int M,
                           int N, int K, int ldn, int ldm, void* stream) {
  return launch_dl<true>(A, B, G, dL, M, N, K, ldn, ldm, stream);
}

// L16 [K, ldm, ldm] bf16 (upper triangle ignored; rows and columns past M
// zero), B16 [K, N, ldm] bf16, G [K, ldn] f32 -> dA [M, N] f32.
extern "C" int mgp_tril_da(const void* L, const void* B, const void* G, void* dA, int M,
                           int N, int K, int ldm, int ldn, void* stream) {
  return launch_da<true>(L, B, G, dA, M, N, K, ldm, ldn, stream);
}

// A16 [M, ldn] bf16, W16 [K, N, ldm] bf16 -> dL [K, M, M] f32, exactly
// lower-triangular.
extern "C" int mgp_tril_dl_w(const void* A, const void* W, void* dL, int M, int N, int K,
                             int ldn, int ldm, void* stream) {
  return launch_dl<false>(A, W, nullptr, dL, M, N, K, ldn, ldm, stream);
}

// L16 [K, ldm, ldm] bf16 (upper triangle ignored), W16 [K, N, ldm] bf16 ->
// dA [M, N] f32.
extern "C" int mgp_tril_da_w(const void* L, const void* W, void* dA, int M, int N, int K,
                             int ldm, void* stream) {
  return launch_da<false>(L, W, nullptr, dA, M, N, K, ldm, (N + 7) / 8 * 8, stream);
}
