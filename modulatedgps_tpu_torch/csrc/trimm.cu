// Banded products of lower-triangular [M, M] fp32 matrices, the three
// M^3 products of the Cholesky pullback (Murray 2016):
//
//   tri_tt:  C[i, j] = sum_{k >= max(i, j)} tril(A)[k, i] tril(B)[k, j]   (A^T B)
//   tri_nt:  C[i, j] = sum_{k >= j}          A[i, k] tril(B)[k, j]        (A B)
//
// Replaces modulatedgps_tpu/ops/pallas_trimm.py:_k_tt (tri_tt_matmul) and
// _k_nt (tri_nt_matmul).
//
// Precision is the trap: the pullback cancels catastrophically, and one
// bf16 pass gave 631x worse Z gradients on the TPU (CHOLPREC_GRADERR_r04).
// So each operand is split as x = hi + lo with hi = x with its low 16 bits
// masked off (exactly a bf16) and lo = bf16_rn(x - hi) (x - hi is exact in
// fp32), and every product is the 3-pass sum hi*hi + hi*lo + lo*hi on bf16
// tensor cores with fp32 accumulators held over the whole contraction, the
// arithmetic of the TPU's _dot3 (HIGH class, ~2^-16 relative).
//
// Bound on the H100: tensor-core math.  At M=4096 tt's band is ~M^3 / 3 =
// 2.3e10 useful multiply-adds, nt's ~M^3 / 2, times 3 passes (0.139 and
// 0.209 ms at the 989 TFLOP/s bf16 peak), against ~0.3-0.4 GB of traffic
// with the split below (~0.12 ms).  Design, two launches:
//   (a) trimm_split_kernel writes the hi and lo bf16 copies of both operands,
//       masked (tril(B), tril(A) for tt: entries above the diagonal are
//       stored as 0, never multiplied, so NaN there never enters a sum) and,
//       for nt's dense A, transposed (At[k][i] = A[i][k]), into a workspace
//       [4, M, ld] (A hi, A lo, B hi, B lo; ld = M rounded up to 8 for TMA's
//       16-byte row strides).  Both products then read two MN-major
//       operands, X[k][i] and Y[k][j], as they lie, the tril forward's
//       situation (tril_product.cuh).
//   (b) tri_mm_kernel: a persistent grid of one CTA per SM, 384 threads: one
//       thread of a producer warpgroup issues TMA loads (128-byte swizzle)
//       into a ring of four 48 KB stages (32 k-rows of X hi / lo for 128 i
//       and Y hi / lo for 256 j) with full / empty mbarriers; two consumer
//       warpgroups (setmaxnreg 40 / 232, no branch around wgmma) each run
//       three chains of wgmma m64n256k16 (hh, hl, lh) into one 64 x 256
//       accumulator of the 128 x 256 output tile.  The tile at (i0, j0)
//       walks k from max(i0, j0) (tt) or j0 (nt): the band only, the terms
//       skipped being exact zeros of the masked operands.  Tiles are walked
//       longest band first (by the k they start from), in a snake over the
//       CTAs.  With lower_out (tt only) the tiles wholly above the diagonal
//       are not work: the producer warpgroup's three idle warps store their
//       zeros while the product runs, and the tiles that straddle the
//       diagonal store 0 where i < j, so C is exactly tril(A^T B).
//   The legacy-wmma kernel this replaced (128 x 128 tiles, a register
//   stage, the split at every store to shared memory, 1024 CTAs) reached
//   ~16% of the bound (PERF.md).
#include "hopper.cuh"

namespace {

using namespace mgp;

constexpr int BI = 128;                    // i rows of a tile: 64 a consumer warpgroup
constexpr int BJ = 256;                    // j columns of a tile
constexpr int BK = 32;                     // k rows a stage
constexpr int STAGES = 4;
constexpr int KBOX = BK * 128;             // a TMA box: 32 rows of 64 bf16 (4 KB)
constexpr int XB = BI / BOX, YB = BJ / BOX;           // boxes of X and of Y (2, 4)
constexpr int X_HI = 0, X_LO = XB * KBOX, Y_HI = 2 * XB * KBOX, Y_LO = Y_HI + YB * KBOX;
constexpr int STAGE_BYTES = 2 * (XB + YB) * KBOX;     // 48 KB
constexpr int NCONS = 256;                 // two consumer warpgroups
constexpr int NTHR = NCONS + 128;          // and the producer's warpgroup
constexpr size_t SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;

enum Mode { kTT = 0, kTTLower = 1, kNT = 2 };

// (hi, lo) bf16 bits of one fp32 value.
__device__ __forceinline__ void split1(float x, unsigned short& hi, unsigned short& lo) {
  const unsigned bits = __float_as_uint(x);
  hi = static_cast<unsigned short>(bits >> 16);
  lo = __bfloat16_as_ushort(__float2bfloat16_rn(x - __uint_as_float(bits & 0xFFFF0000u)));
}

// One operand of the split: source [M, M] fp32 row-major; hi / lo [M, ld].
struct SplitArg {
  const float* src;
  unsigned short* hi;
  unsigned short* lo;
  int lower;   // store source entries above the diagonal (c > r) as 0
  int trans;   // out[c][r] = split(src[r][c])
};

// A 32 x 32 tile of the source per block of 32 x 8 threads, through shared
// memory so that both its reads and its (transposed) writes run along rows;
// blockIdx.z picks the operand.  Columns ld > M of the copies stay unwritten
// (TMA's maps end at M).
__global__ void __launch_bounds__(256)
trimm_split_kernel(SplitArg a0, SplitArg a1, int M, int ld) {
  __shared__ float tile[32][33];
  const SplitArg a = blockIdx.z ? a1 : a0;
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int y = ty; y < 32; y += 8) {
    const int r = r0 + y, c = c0 + tx;
    float v = 0.f;
    if (r < M && c < M && !(a.lower && c > r)) v = a.src[(size_t)r * M + c];
    tile[y][tx] = v;
  }
  __syncthreads();
  for (int y = ty; y < 32; y += 8) {
    // Output row o, column q: source (o, q), or (q, o) transposed.
    const int o = (a.trans ? c0 : r0) + y, q = (a.trans ? r0 : c0) + tx;
    if (o >= M || q >= M) continue;
    unsigned short h, l;
    split1(a.trans ? tile[tx][y] : tile[y][tx], h, l);
    a.hi[(size_t)o * ld + q] = h;
    a.lo[(size_t)o * ld + q] = l;
  }
}

// The work tiles (i-tile a of BI rows, j-tile b of BJ columns), longest band
// first: level d = kb / 128 for the k row kb the tile starts from (tt:
// max(128 a, 256 b); nt: 256 b), each level's tiles in a fixed order.
struct Tiles {
  int ni, nj, mode;
  __device__ int count(int d) const {
    const int lo = d < ni ? min(d / 2, nj - 1) + 1 : 0;   // a = d, 2 b <= d
    const int hi = (d % 2 == 0 && d / 2 < nj) ? min(d, ni) : 0;   // b = d / 2, a < d
    if (mode == kTTLower) return lo;
    if (mode == kTT) return lo + hi;
    return (d % 2 == 0 && d / 2 < nj) ? ni : 0;
  }
  __device__ void coords(int d, int idx, int& a, int& b) const {
    const int lo = d < ni ? min(d / 2, nj - 1) + 1 : 0;
    if (mode == kNT) {
      a = idx;
      b = d / 2;
    } else if (idx < lo) {
      a = d;
      b = idx;
    } else {
      a = idx - lo;
      b = d / 2;
    }
  }
  __device__ int kb(int a, int b) const { return mode == kNT ? BJ * b : max(BI * a, BJ * b); }
};

// Walks the list for one CTA's non-decreasing tile numbers.
struct Cursor {
  int d = 0, base = 0;
  __device__ bool at(const Tiles& tl, int t, int& a, int& b) {
    for (; d < tl.ni + 2 * tl.nj; base += tl.count(d), ++d)
      if (t < base + tl.count(d)) {
        tl.coords(d, t - base, a, b);
        return true;
      }
    return false;
  }
};

// Tile `it` of CTA b of G: a snake, so a CTA given a long tile in one wave
// gets a short one in the next.
__device__ __forceinline__ int snake(int it) {
  return it * gridDim.x + ((it & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

__global__ void __launch_bounds__(NTHR, 1)
tri_mm_kernel(const __grid_constant__ CUtensorMap mapXh, const __grid_constant__ CUtensorMap mapXl,
              const __grid_constant__ CUtensorMap mapYh, const __grid_constant__ CUtensorMap mapYl,
              float* __restrict__ C, int M, int mode) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  const Tiles tl{(M + BI - 1) / BI, (M + BJ - 1) / BJ, mode};

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);     // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCONS) {
    producer_regs();
    if (tid == NCONS) {            // one thread issues the TMA loads
      Cursor cur;
      int stage = 0;
      uint32_t phase = 0;
      int a, b;
      for (int it = 0; cur.at(tl, snake(it), a, b); ++it) {
        const int i0 = a * BI, j0 = b * BJ;
        for (int k0 = tl.kb(a, b); k0 < M; k0 += BK) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          uint8_t* st = smem + stage * STAGE_BYTES;
          for (int h = 0; h < XB; ++h) {
            tma_load_2d(st + X_HI + h * KBOX, &mapXh, &full[stage], i0 + h * BOX, k0);
            tma_load_2d(st + X_LO + h * KBOX, &mapXl, &full[stage], i0 + h * BOX, k0);
          }
          for (int h = 0; h < YB; ++h) {
            tma_load_2d(st + Y_HI + h * KBOX, &mapYh, &full[stage], j0 + h * BOX, k0);
            tma_load_2d(st + Y_LO + h * KBOX, &mapYl, &full[stage], j0 + h * BOX, k0);
          }
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
    } else if (tid >= NCONS + 32 && mode == kTTLower) {
      // The zeros of the tiles wholly above the diagonal: row i's start at
      // the first j-tile past its i-tile's last scheduled one.
      const int t = tid - NCONS - 32, nt = NTHR - NCONS - 32;
      for (int i = blockIdx.x; i < M; i += gridDim.x) {
        float* row = C + (size_t)i * M;
        const int c0 = BJ * ((i / BI) / 2 + 1);
        if (M % 4 == 0)
          for (int c = c0 + 4 * t; c < M; c += 4 * nt)
            *reinterpret_cast<float4*>(row + c) = make_float4(0.f, 0.f, 0.f, 0.f);
        else
          for (int c = c0 + t; c < M; c += nt) row[c] = 0.f;
      }
    }
    return;
  }

  consumer_regs();
  const int wg = tid / 128, lt = tid % 128, lane = lt % 32, wq = lt / 32;
  Cursor cur;
  int stage = 0;
  uint32_t phase = 0;
  float acc[128];
  int a, b;
  for (int it = 0; cur.at(tl, snake(it), a, b); ++it) {
    const int i0 = a * BI, j0 = b * BJ;
#pragma unroll
    for (int q = 0; q < 128; ++q) acc[q] = 0.f;
    int held = -1;                 // the stage the wgmma group in flight reads
    for (int k0 = tl.kb(a, b); k0 < M; k0 += BK) {
      mbar_wait(&full[stage], phase);
      const uint32_t base = smem_u32(smem + stage * STAGE_BYTES);
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {   // 16 k-rows = 2 atoms of 8 rows
        const uint64_t xh = desc_mn_sw128(base + X_HI + wg * KBOX + kk * 2048, KBOX, 1024);
        const uint64_t xl = desc_mn_sw128(base + X_LO + wg * KBOX + kk * 2048, KBOX, 1024);
        const uint64_t yh = desc_mn_sw128(base + Y_HI + kk * 2048, KBOX, 1024);
        const uint64_t yl = desc_mn_sw128(base + Y_LO + kk * 2048, KBOX, 1024);
        wgmma_m64n256(acc, xh, yh);
        wgmma_m64n256(acc, xh, yl);
        wgmma_m64n256(acc, xl, yh);
      }
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
    // acc[4 c + 2 h + e] is row i0 + 64 wg + 16 wq + lane / 4 + 8 h, column
    // j0 + 8 c + 2 (lane % 4) + e.
    const bool lower = mode == kTTLower, vec = M % 2 == 0;
    const int row0 = i0 + 64 * wg + 16 * wq + lane / 4;
#pragma unroll
    for (int c = 0; c < BJ / 8; ++c) {
      const int j = j0 + 8 * c + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = row0 + 8 * h;
        if (i >= M || j >= M) continue;
        const float v0 = (lower && i < j) ? 0.f : acc[4 * c + 2 * h];
        const float v1 = (lower && i < j + 1) ? 0.f : acc[4 * c + 2 * h + 1];
        float* dst = C + (size_t)i * M + j;
        if (vec && j + 1 < M) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (j + 1 < M) dst[1] = v1;
        }
      }
    }
  }
}

// Work tiles of the list (the grid is never larger).
int tile_count(int M, int mode) {
  const int ni = (M + BI - 1) / BI, nj = (M + BJ - 1) / BJ;
  if (mode == kNT) return ni * nj;
  int n = 0;
  for (int a = 0; a < ni; ++a)
    for (int b = 0; b < nj; ++b) n += (mode == kTT || a >= 2 * b);
  return n;
}

// ws [4, M, ld] bf16: X hi, X lo, Y hi, Y lo.  C = X^T Y over the band.
int launch(const float* A, const float* B, float* C, void* ws, int M, int mode,
           cudaStream_t stream) {
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  const int ld = (M + 7) / 8 * 8;
  unsigned short* w = static_cast<unsigned short*>(ws);
  const size_t plane = (size_t)M * ld;
  const SplitArg x{A, w, w + plane, mode != kNT, mode == kNT};
  const SplitArg y{B, w + 2 * plane, w + 3 * plane, 1, 0};
  const dim3 sgrid((M + 31) / 32, (M + 31) / 32, 2);
  trimm_split_kernel<<<sgrid, 256, 0, stream>>>(x, y, M, ld);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap maps[4];
  const cuuint64_t dims[2] = {(cuuint64_t)M, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  for (int q = 0; q < 4; ++q)
    if (!encode_bf16(&maps[q], 2, w + q * plane, dims, strides, BK))
      return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(tri_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = tile_count(M, mode);
  const int grid = tiles < sms ? tiles : sms;
  tri_mm_kernel<<<grid, NTHR, SMEM_BYTES, stream>>>(maps[0], maps[1], maps[2], maps[3], C, M,
                                                    mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A, B [M, M] fp32 row-major (upper triangles ignored) -> C = tril(A)^T tril(B)
// [M, M] fp32; with lower_out, C is exactly the lower triangle of that product.
// ws: bf16 scratch [4, M, ld], ld = M rounded up to a multiple of 8.
extern "C" int mgp_tri_tt(const void* A, const void* B, void* C, void* ws, int M,
                          int lower_out, void* stream) {
  return launch(static_cast<const float*>(A), static_cast<const float*>(B),
                static_cast<float*>(C), ws, M, lower_out ? kTTLower : kTT,
                static_cast<cudaStream_t>(stream));
}

// A [M, M] fp32 dense, B [M, M] fp32 (upper triangle ignored) -> C = A tril(B);
// ws as for mgp_tri_tt.
extern "C" int mgp_tri_nt(const void* A, const void* B, void* C, void* ws, int M,
                          void* stream) {
  return launch(static_cast<const float*>(A), static_cast<const float*>(B),
                static_cast<float*>(C), ws, M, kNT, static_cast<cudaStream_t>(stream));
}
