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
// Bound on the H100: tensor-core math.  At M=4096 one pullback is ~M^3 =
// 6.9e10 useful multiply-adds, times 3 passes, against 3 x 64 MB of
// operands and results.  Only the band is visited: a block computing the
// output tile (i-tile, j-tile) walks k from max(i0, j0) (tt) or j0 (nt) to
// M, and the lower-triangular operands have their upper entries zeroed as
// they are staged, so garbage above a diagonal never enters a sum.  With
// lower_out (tt only) the blocks above the diagonal write zeros and the
// diagonal blocks zero their upper part: the result is exactly tril(A^T B).
// Loads of the next step are issued into registers before the current
// step's MMAs; masking and splitting happen at the store to shared memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include "tiles.cuh"

using namespace nvcuda;

namespace {

constexpr int BT = 128;        // output tile edge
constexpr int BK = 32;         // contraction depth per step
constexpr int NTHR = 256;      // 8 warps: 2 along i x 4 along j
constexpr int WR = 64;
constexpr int WC = 32;
constexpr int FR = WR / 16;
constexpr int FC = WC / 16;
constexpr int LDW = BT + 8;    // pitch of a [BK][BT] tile
constexpr int LDT = BK + 8;    // pitch of a [BT][BK] tile
static_assert(BT / WR * (BT / WC) == NTHR / 32, "warp grid covers the tile");

// A^T (tt) is read as a column-major matrix_a, A (nt) as a row-major one.
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragAN = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;

// (hi, lo) bf16 bits of one fp32 value.
__device__ __forceinline__ void split1(float x, unsigned short& hi, unsigned short& lo) {
  const unsigned bits = __float_as_uint(x);
  hi = static_cast<unsigned short>(bits >> 16);
  lo = __bfloat16_as_ushort(__float2bfloat16_rn(x - __uint_as_float(bits & 0xFFFF0000u)));
}

// A [ROWS][COLS] fp32 tile of a row-major [n, n] matrix, held in registers
// as 4-float chunks between its load and its split into shared memory.
template <int ROWS, int COLS>
struct Tile {
  static constexpr int CHUNKS = ROWS * COLS / 4 / NTHR;
  static constexpr int LD = COLS + 8;
  float4 r[CHUNKS];
  static_assert(CHUNKS * 4 * NTHR == ROWS * COLS, "chunks cover the tile");

  __device__ __forceinline__ void fetch(const float* __restrict__ X, int n, int row0,
                                        int col0, bool vec) {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int e = threadIdx.x + c * NTHR;
      r[c] = mgp::load_row4(X, row0 + e / (COLS / 4), col0 + (e % (COLS / 4)) * 4, n, vec);
    }
  }

  // Splits the held chunks into hi and lo [ROWS][LD] tiles; with lower,
  // entries above the matrix's diagonal (row < col) are staged as 0.
  __device__ __forceinline__ void store(__nv_bfloat16* hi, __nv_bfloat16* lo, int row0,
                                        int col0, bool lower) const {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int e = threadIdx.x + c * NTHR;
      const int rr = e / (COLS / 4), cc = (e % (COLS / 4)) * 4;
      const float v[4] = {r[c].x, r[c].y, r[c].z, r[c].w};
      unsigned short h[4], l[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split1((lower && row0 + rr < col0 + cc + q) ? 0.f : v[q], h[q], l[q]);
      *reinterpret_cast<uint2*>(&hi[rr * LD + cc]) =
          make_uint2(h[0] | (unsigned)h[1] << 16, h[2] | (unsigned)h[3] << 16);
      *reinterpret_cast<uint2*>(&lo[rr * LD + cc]) =
          make_uint2(l[0] | (unsigned)l[1] << 16, l[2] | (unsigned)l[3] << 16);
    }
  }
};

// acc += a * b over one 16-deep slice in 3 passes, ah*bh + ah*bl + al*bh.
// The warp's i-th 16-row fragment of a starts a_step * 16 elements after
// the first; b's j-th 16-column fragment 16 elements after the first.
template <typename FragA>
__device__ __forceinline__ void mma3(mgp::Acc (&acc)[FR][FC], const __nv_bfloat16* ah,
                                     const __nv_bfloat16* al, int a_step, int lda,
                                     const __nv_bfloat16* bh, const __nv_bfloat16* bl,
                                     int ldb) {
  FragB fbh[FC], fbl[FC];
#pragma unroll
  for (int j = 0; j < FC; ++j) {
    wmma::load_matrix_sync(fbh[j], bh + j * 16, ldb);
    wmma::load_matrix_sync(fbl[j], bl + j * 16, ldb);
  }
#pragma unroll
  for (int i = 0; i < FR; ++i) {
    FragA fah, fal;
    wmma::load_matrix_sync(fah, ah + i * 16 * a_step, lda);
    wmma::load_matrix_sync(fal, al + i * 16 * a_step, lda);
#pragma unroll
    for (int j = 0; j < FC; ++j) {
      wmma::mma_sync(acc[i][j], fah, fbh[j], acc[i][j]);
      wmma::mma_sync(acc[i][j], fah, fbl[j], acc[i][j]);
      wmma::mma_sync(acc[i][j], fal, fbh[j], acc[i][j]);
    }
  }
}

__global__ void __launch_bounds__(NTHR)
tri_tt_kernel(const float* __restrict__ A, const float* __restrict__ B,
              float* __restrict__ C, int M, int lower_out) {
  __shared__ __align__(32) __nv_bfloat16 Ah[BK * LDW], Al[BK * LDW];   // [k][i]
  __shared__ __align__(32) __nv_bfloat16 Bh[BK * LDW], Bl[BK * LDW];   // [k][j]
  __shared__ __align__(32) float stage[NTHR / 32][16 * 16];

  const int j0 = blockIdx.x * BT;
  const int i0 = blockIdx.y * BT;
  if (lower_out && i0 < j0) {
    mgp::zero_tile(C, M, M, M, i0, j0, BT);
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / (BT / WC);
  const int wc = warp % (BT / WC);
  const bool vec = (M % 4) == 0;

  mgp::Acc acc[FR][FC];
#pragma unroll
  for (int i = 0; i < FR; ++i)
#pragma unroll
    for (int j = 0; j < FC; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  Tile<BK, BT> ta, tb;
  const int kb = max(i0, j0);
  ta.fetch(A, M, kb, i0, vec);
  tb.fetch(B, M, kb, j0, vec);
  for (int k0 = kb; k0 < M; k0 += BK) {
    ta.store(Ah, Al, k0, i0, true);
    tb.store(Bh, Bl, k0, j0, true);
    __syncthreads();
    if (k0 + BK < M) {
      ta.fetch(A, M, k0 + BK, i0, vec);
      tb.fetch(B, M, k0 + BK, j0, vec);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // A^T as matrix_a: element (i, k) sits at Ah[k * LDW + i] (col_major).
      const int a0 = kk * LDW + wr * WR, b0 = kk * LDW + wc * WC;
      mma3<FragAT>(acc, Ah + a0, Al + a0, 1, LDW, Bh + b0, Bl + b0, LDW);
    }
    __syncthreads();
  }

  mgp::store_acc(acc, stage[warp], C, M, M, M, i0 + wr * WR, j0 + wc * WC,
                 lower_out != 0, lane);
}

__global__ void __launch_bounds__(NTHR)
tri_nt_kernel(const float* __restrict__ A, const float* __restrict__ B,
              float* __restrict__ C, int M) {
  __shared__ __align__(32) __nv_bfloat16 Ah[BT * LDT], Al[BT * LDT];   // [i][k]
  __shared__ __align__(32) __nv_bfloat16 Bh[BK * LDW], Bl[BK * LDW];   // [k][j]
  __shared__ __align__(32) float stage[NTHR / 32][16 * 16];

  const int j0 = blockIdx.x * BT;
  const int i0 = blockIdx.y * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / (BT / WC);
  const int wc = warp % (BT / WC);
  const bool vec = (M % 4) == 0;

  mgp::Acc acc[FR][FC];
#pragma unroll
  for (int i = 0; i < FR; ++i)
#pragma unroll
    for (int j = 0; j < FC; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  Tile<BT, BK> ta;
  Tile<BK, BT> tb;
  ta.fetch(A, M, i0, j0, vec);
  tb.fetch(B, M, j0, j0, vec);
  for (int k0 = j0; k0 < M; k0 += BK) {
    ta.store(Ah, Al, i0, k0, false);
    tb.store(Bh, Bl, k0, j0, true);
    __syncthreads();
    if (k0 + BK < M) {
      ta.fetch(A, M, i0, k0 + BK, vec);
      tb.fetch(B, M, k0 + BK, j0, vec);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const int a0 = wr * WR * LDT + kk, b0 = kk * LDW + wc * WC;
      mma3<FragAN>(acc, Ah + a0, Al + a0, LDT, LDT, Bh + b0, Bl + b0, LDW);
    }
    __syncthreads();
  }

  mgp::store_acc(acc, stage[warp], C, M, M, M, i0 + wr * WR, j0 + wc * WC,
                 false, lane);
}

}  // namespace

// A, B [M, M] fp32 row-major (upper triangles ignored) -> C = tril(A)^T tril(B)
// [M, M] fp32; with lower_out, C is exactly the lower triangle of that product.
extern "C" int mgp_tri_tt(const void* A, const void* B, void* C, int M,
                          int lower_out, void* stream) {
  if (M > 0) {
    const int nt = (M + BT - 1) / BT;
    tri_tt_kernel<<<dim3(nt, nt), NTHR, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(A), static_cast<const float*>(B),
        static_cast<float*>(C), M, lower_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// A [M, M] fp32 dense, B [M, M] fp32 (upper triangle ignored) -> C = A tril(B).
extern "C" int mgp_tri_nt(const void* A, const void* B, void* C, int M, void* stream) {
  if (M > 0) {
    const int nt = (M + BT - 1) / BT;
    tri_nt_kernel<<<dim3(nt, nt), NTHR, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(A), static_cast<const float*>(B),
        static_cast<float*>(C), M);
  }
  return static_cast<int>(cudaGetLastError());
}
