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
// Design (Hopper): the product is a GEMM with wgmma's M = n (64-row slabs),
// N = m' (BP = 256) and K = m.  A [M, N] is n-contiguous and L_k [M, M] is
// m'-contiguous, so both tiles are MN-major operands as they lie in memory,
// which bf16 wgmma reads through the transpose bits: no transpose anywhere.
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
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <stdint.h>

#include "tiles.cuh"

namespace {

constexpr int BN = 128;        // n rows of the output tile (two warpgroups of 64)
constexpr int BP = 256;        // m' columns of the output tile
constexpr int BK = 64;         // m depth per stage
constexpr int STAGES = 4;
constexpr int BOX = 64;        // a TMA box is 64 x 64 bf16 (128-byte rows)
constexpr int CHUNK = BOX * BOX * 2;              // bytes of one box (8 KB)
constexpr int LBOXES = BP / BOX;                  // L boxes a stage
constexpr int STAGE_BYTES = (2 + LBOXES) * CHUNK; // A: 2 boxes, then L's
constexpr int NACC = BP / 2;                      // fp32 accumulators a thread
constexpr int NCONS = 256;                        // two consumer warpgroups
constexpr int NTHR = NCONS + 32;                  // and one producer warp
constexpr size_t SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;

using mgp::Pack8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor for an MN-major operand in 128-byte
// swizzled 64-element atoms: start address, the byte offset between atoms
// along M / N (lbo) and between groups of 8 rows along K (sbo).
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_operands(float (&d)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 256] += A[64 x 16] B[16 x 256], bf16 operands from shared memory
// through the descriptors, fp32 accumulators in registers; both operands
// MN-major (the transpose bits set).
__device__ __forceinline__ void wgmma_tile(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Zero the entries with m < m' of the stage's L boxes (rows m = p0 + dm +
// r, columns m' = p0 + 64 h + c), in their 128-byte swizzled layout: the
// 16-byte granule g of row r sits at r * 128 + ((g ^ (r % 8)) * 16).
__device__ __forceinline__ void zero_upper(uint8_t* Lst, int dm, int tid) {
  for (int e = tid; e < LBOXES * BOX * 8; e += NCONS) {
    const int h = e / (BOX * 8), r = (e / 8) % BOX, g = e % 8;
    const int c0 = BOX * h + 8 * g;   // first m' of the granule, from p0
    const int m = dm + r;             // its m, from p0
    if (m >= c0 + 7) continue;        // on or below the diagonal throughout
    uint4* ptr = reinterpret_cast<uint4*>(Lst + h * CHUNK + r * 128 + ((g ^ (r & 7)) << 4));
    Pack8 v;
    v.u = *ptr;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (m < c0 + q) v.s[q] = 0;
    *ptr = v.u;
  }
}

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
        zero_upper(st + 2 * CHUNK, m0 - p0, tid);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("bar.sync 1, %0;" ::"n"(NCONS) : "memory");
      }
      const uint32_t a_base = smem_u32(st + wg * CHUNK);
      const uint32_t l_base = smem_u32(st + 2 * CHUNK);
      fence_operands(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)   // 16 m-rows = 2 atoms of 8 rows
        wgmma_tile(acc, desc_mn_sw128(a_base + kk * 2048, CHUNK, 1024),
                   desc_mn_sw128(l_base + kk * 2048, CHUNK, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      // Keep this step's group in flight: wait for the one before it and
      // hand its stage back to the producer.
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_operands(acc);
      if (held >= 0 && lt == 0) mbar_arrive(&empty[held]);
      held = stage;
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, looked up once in the driver library the
// CUDA runtime has loaded (no link against libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

bool encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides) {
  const cuuint32_t box[3] = {BOX, BOX, 1}, one[3] = {1, 1, 1};
  EncodeTiled fn = encoder();
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
            strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
  if (!encode(&mapA, A, 2, dimsA, strideA) || !encode(&mapL, L, 3, dimsL, strideL))
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
