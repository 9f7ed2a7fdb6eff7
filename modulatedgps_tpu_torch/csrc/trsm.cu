// Blocked substitution for a lower-triangular L: forward, X = L^-1 B, and
// backward, X = L^-T B.
//
// Replaces modulatedgps_tpu/ops/pallas_linalg.py:_trsm_kernel (with its
// _chol_diag_inverses and the 512-row panel loop of _trsm_large_impl) and
// _trsm_t_kernel (the transposed solve: the unwhitened conditional's second
// solve and the pullback of every forward solve).
//
// Bound on the H100: fp32 FMA only (the TPU ran these products at HIGHEST;
// the tensor cores have no full-fp32 rate).  With a wide B (Nb = 8192 or
// 32768 columns on the unwhitened path) the solve is bound by the fp32 FMA
// rate, M^2 Nb / 2 multiply-adds (2.05 ms at [4096, 8192] at 67 TFLOP/s;
// in practice by shared-memory bandwidth, below);
// for the inverse (B = I) and a narrow B by its critical walk down one
// column strip, (M/64)^2 / 2 tile products in sequence.  Design, two
// launches:
//   (a) one CUDA block per 64x64 diagonal block inverts it by substitution
//       in shared memory (a ragged tail is padded with the identity); a
//       caller holding the inverses from the Cholesky (chol.cu, which
//       launches this same kernel through mgp_diag_inv) skips it;
//   (b) one CUDA block per column strip of B walks the block rows in
//       order: acc = B_k - sum_j L_kj X_j, then X_k = Inv_kk acc.  The
//       TPU's sequential fori_loop over row blocks becomes this in-block
//       loop; strips run in parallel with nothing carried between them.
//       The transposed solve is the same walk from the last block row up,
//       reading L_jk^T; it reuses (a), since the diagonal blocks of L^T have
//       the inverses Inv_kk^T.  Two kernels, chosen by a shape rule in the
//       launcher (kWideMinNb):
//     - solve_kernel (the inverse and Nb < kWideMinNb): 16-column strips,
//       which shorten the critical walk and give ~2 blocks per SM at
//       M=4096; each thread holds a 4x1 tile; the next (L_kj, X_j) pair is
//       prefetched into registers.
//     - wide_solve_kernel (a general B with Nb >= kWideMinNb): 64-column
//       strips (Nb = 8192 is 128 blocks, one wave), a 4x4 register tile a
//       thread, so one 16-byte shared load of L and one of X feed 16 FMAs
//       (the narrow kernel's 4x1 tile took 5 loads for 4).  A 16-byte
//       shared load fills four registers of one thread and shared memory
//       delivers 128 bytes a clock, so 8 floats loaded per 16 FMAs hold the
//       SM's 128 FMA lanes to about half their rate: the kernel is bound by
//       shared-memory bandwidth, not by the FMA rate.  (4x2 tiles on
//       32-column strips, and 8x8 tiles on two block rows at a time with 4
//       warps an SM, were slower on an H100: PERF.md.)  The (L_kj, X_j)
//       pairs and the Inv_kk tiles stream through a ring of three stages by
//       cp.async (the generic proxy, L2 only: X_j was written by this block
//       one block row earlier, ordered by a __syncthreads after the store);
//       a pair whose X_j is not written yet waits in the queue.  Tiles stay
//       as they lie in memory: the forward reads L_kj along its rows, the
//       transposed walk L_jk along its rows, both as float4.
//   Each output keeps the narrow kernel's fmaf order (j ascending, p = 0..63
//   within a tile, then the Inv product from zero), so both kernels give
//   the same bits.  With B = I (unit_rhs) or a right side that is
//   lower-triangular in each run of M columns (tril_rhs: the unwhitened
//   KL's [M, K*M]) a strip starts at the block row holding its first
//   column, the rows above written as zeros; a strip holding columns of two
//   such runs starts at row 0.  Skipped terms are exact zeros times a finite
//   L, so the result equals the unskipped walk's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BS = 64;        // diagonal block size
constexpr int TW = 16;        // columns per narrow strip
constexpr int NT = 256;       // threads per solve block
constexpr int RY = NT / TW;   // thread rows (16)
constexpr int RR = BS / RY;   // rows per thread (4)
constexpr int LPT = BS * BS / NT;  // L-tile elements per thread (16)
constexpr int XPT = BS * TW / NT;  // X-tile elements per thread (4)
constexpr int WW = 64;        // columns per wide strip
constexpr int CW = WW / 16;   // columns per thread of the wide kernel (4)
constexpr int STAGES = 3;     // the wide kernel's ring
constexpr int LDT = BS + 4;   // the wide kernel's row pitch of a staged L or Inv tile
constexpr int kWideMinNb = 4096;   // a general B at least this wide takes the wide kernel

__global__ void __launch_bounds__(BS)
diag_inv_kernel(const float* __restrict__ L, float* __restrict__ Inv, int M) {
  __shared__ float Ls[BS][BS + 1];
  __shared__ float Xs[BS][BS + 1];
  const int base = blockIdx.x * BS;
  const int j = threadIdx.x;
  for (int i = 0; i < BS; ++i) {
    int r = base + i, c = base + j;
    float v;
    if (r < M && c < M) v = (j <= i) ? L[(size_t)r * M + c] : 0.f;
    else v = (i == j) ? 1.f : 0.f;
    Ls[i][j] = v;
  }
  __syncthreads();
  // Thread j forms column j of the inverse; it reads only its own column.
  for (int i = 0; i < BS; ++i) {
    float acc = (i == j) ? 1.f : 0.f;
    for (int p = j; p < i; ++p) acc = fmaf(-Ls[i][p], Xs[p][j], acc);
    Xs[i][j] = (i >= j) ? acc / Ls[i][i] : 0.f;
  }
  float* out = Inv + (size_t)blockIdx.x * BS * BS;
  for (int i = 0; i < BS; ++i) out[i * BS + j] = Xs[i][j];
}

// The first block row a strip of `w` columns from c0 must compute when each
// run of M columns of the right side is lower-triangular: that of its first
// column within the run, or 0 when the strip holds columns of two runs.
__device__ __forceinline__ int first_block(int c0, int w, int M, int Nb) {
  const int lc = c0 % M;
  return (lc + w <= M || c0 - lc + M >= Nb) ? lc / BS : 0;
}

// kTrans = false: L X = B, block rows in order, acc = B_k - sum_{j<k} L_kj X_j,
// X_k = Inv_kk acc.  kTrans = true: L^T X = B, block rows in reverse,
// acc = B_k - sum_{j>k} L_jk^T X_j, X_k = Inv_kk^T acc (the diagonal blocks of
// L^T have the inverses Inv_kk^T).  The transposed solve reads L_jk and
// Inv_kk row by row from device memory (coalesced) and stores them
// transposed into shared memory, so the product loop is the same for both.
template <bool kTrans>
__global__ void __launch_bounds__(NT)
solve_kernel(const float* __restrict__ L, const float* __restrict__ Inv,
             const float* __restrict__ B, float* __restrict__ X, int M, int Nb,
             int unit_rhs, int tril_rhs) {
  __shared__ float Ls[BS][BS + 1];
  __shared__ float Xs[BS][TW + 1];
  const int tid = threadIdx.x;
  const int tx = tid % TW, ty = tid / TW;
  const int c0 = blockIdx.x * TW;
  const int col = c0 + tx;
  const bool col_ok = col < Nb;
  const int nblk = (M + BS - 1) / BS;
  const int kstart = (!kTrans && (unit_rhs || tril_rhs)) ? first_block(c0, TW, M, Nb) : 0;

  if (col_ok)
    for (int r = ty; r < min(kstart * BS, M); r += RY) X[(size_t)r * Nb + col] = 0.f;

  // Element e of a [BS, BS] tile read row-major, stored as Ls[e / BS][e % BS]
  // or, transposed, as Ls[e % BS][e / BS] (stride BS + 1: no bank conflicts).
  auto stage = [&](int e, float v) {
    if (kTrans) Ls[e % BS][e / BS] = v;
    else Ls[e / BS][e % BS] = v;
  };

  // Registers for the next (L tile, X_j) pair: L_kj (forward, j < k) or
  // L_jk (transposed, j > k).  The tile's columns are inside M (they belong
  // to the smaller of j, k, never the last block); its rows, and X_j's, may
  // run past M in the transposed solve's last block row and read as 0.
  float lr[LPT], xr[XPT];
  auto fetch = [&](int k, int j) {
    const int rb = kTrans ? j : k, cb = kTrans ? k : j;
#pragma unroll
    for (int q = 0; q < LPT; ++q) {
      const int e = tid + q * NT;
      const int r = rb * BS + e / BS;
      lr[q] = (r < M) ? L[(size_t)r * M + cb * BS + e % BS] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < XPT; ++q) {
      const int e = tid + q * NT;
      const int c = c0 + e % TW;
      const int r = j * BS + e / TW;
      xr[q] = (c < Nb && r < M) ? X[(size_t)r * Nb + c] : 0.f;
    }
  };

  for (int s = 0; s < nblk - kstart; ++s) {
    const int k = kTrans ? nblk - 1 - s : kstart + s;
    const int jlo = kTrans ? k + 1 : kstart;   // the substituted block rows
    const int jhi = kTrans ? nblk : k;
    float acc[RR];
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      int r = k * BS + ty + i * RY;
      if (unit_rhs) acc[i] = (r == col) ? 1.f : 0.f;
      else acc[i] = (r < M && col_ok) ? B[(size_t)r * Nb + col] : 0.f;
    }
    if (jlo < jhi) fetch(k, jlo);
    for (int j = jlo; j < jhi; ++j) {
#pragma unroll
      for (int q = 0; q < LPT; ++q) stage(tid + q * NT, lr[q]);
#pragma unroll
      for (int q = 0; q < XPT; ++q) {
        const int e = tid + q * NT;
        Xs[e / TW][e % TW] = xr[q];
      }
      __syncthreads();
      if (j + 1 < jhi) fetch(k, j + 1);
#pragma unroll 16
      for (int p = 0; p < BS; ++p) {
        float xv = Xs[p][tx];
#pragma unroll
        for (int i = 0; i < RR; ++i) acc[i] = fmaf(-Ls[ty + i * RY][p], xv, acc[i]);
      }
      __syncthreads();
    }
    // X_k = Inv_kk acc (forward) or Inv_kk^T acc (transposed)
#pragma unroll
    for (int i = 0; i < RR; ++i) Xs[ty + i * RY][tx] = acc[i];
    const float* inv = Inv + (size_t)k * BS * BS;
#pragma unroll
    for (int q = 0; q < LPT; ++q) stage(tid + q * NT, inv[tid + q * NT]);
    __syncthreads();
    float out[RR];
#pragma unroll
    for (int i = 0; i < RR; ++i) out[i] = 0.f;
#pragma unroll 16
    for (int p = 0; p < BS; ++p) {
      float xv = Xs[p][tx];
#pragma unroll
      for (int i = 0; i < RR; ++i) out[i] = fmaf(Ls[ty + i * RY][p], xv, out[i]);
    }
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      int r = k * BS + ty + i * RY;
      if (r < M && col_ok) X[(size_t)r * Nb + col] = out[i];
    }
    // Makes X_k visible to the whole block before a later row reads it,
    // and frees the shared tiles.
    __syncthreads();
  }
}

// --- the wide kernel's plumbing: cp.async with zero fill, in 16-byte
// chunks where rows are 16-byte aligned, else 4-byte words.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most n (0 .. STAGES - 1) groups are still in flight.
__device__ __forceinline__ void cp_wait(int n) {
  static_assert(STAGES <= 4, "cp_wait covers up to 3 groups in flight");
  if (n <= 0) asm volatile("cp.async.wait_group 0;" ::: "memory");
  else if (n == 1) asm volatile("cp.async.wait_group 1;" ::: "memory");
  else if (n == 2) asm volatile("cp.async.wait_group 2;" ::: "memory");
  else asm volatile("cp.async.wait_group 3;" ::: "memory");
}

// Rows r0 .. r0 + 63, columns c0 .. c0 + W - 1 of a row-major array with
// row stride ld into dst [64][DP] (row pitch DP >= W); rows >= rmax or
// columns >= cmax read as 0.  vec: ld, c0 and cmax multiples of 4 and src
// 16-byte aligned.
template <int W, int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int ld, int r0,
                                          int c0, int rmax, int cmax, bool vec, int tid) {
  if (vec) {
#pragma unroll
    for (int e = tid; e < BS * W / 4; e += NT) {
      const int r = e / (W / 4), c = (e % (W / 4)) * 4;
      const bool ok = r0 + r < rmax && c0 + c < cmax;
      cp_async16(dst + r * DP + c, ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
    }
  } else {
    for (int e = tid; e < BS * W; e += NT) {
      const int r = e / W, c = e % W;
      const bool ok = r0 + r < rmax && c0 + c < cmax;
      cp_async4(dst + r * DP + c, ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
    }
  }
}

// Four floats from one 16-byte load (shared or device memory).
__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// The operands of p .. p + 3: t[i][q] = T[row_i][p + q] and y[q][c] =
// Y[p + q][cc + c] (see tile_product).
template <bool kTrans>
__device__ __forceinline__ void tile_operands(const float* Ts, const float* Ys, int r, int cc,
                                              int p, float (&t)[4][4], float (&y)[4][CW]) {
  if (kTrans) {
    float s[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) ld4(Ts + (p + q) * LDT + r, s[q]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) t[i][q] = s[q][i];
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) ld4(Ts + (r + 16 * i) * LDT + p, t[i]);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) ld4(Ys + (p + q) * WW + cc, y[q]);
}

// acc[i][c] (+/-)= sum_p T[row_i][p] Y[p][cc + c], p = 0..63 in order, one
// fmaf each: T = L_kj or Inv_kk as stored row-major (forward; rows row_i =
// r + 16 i), or T = S^T for S = L_jk or Inv_kk as stored row-major (kTrans;
// rows row_i = r + i).  Ts [64][LDT], Ys [64][WW].  A warp's threads read
// four rows and eight column groups, free of bank conflicts (the forward's
// rows 16 apart fall on distinct banks at pitch LDT).  The operands of the
// next four p are loaded while the current four multiply.
template <bool kTrans, bool kNeg>
__device__ __forceinline__ void tile_product(const float* Ts, const float* Ys, int r, int cc,
                                             float (&acc)[4][CW]) {
  float t[2][4][4], y[2][4][CW];   // t[.][i][q] = T[row_i][p + q]
  tile_operands<kTrans>(Ts, Ys, r, cc, 0, t[0], y[0]);
#pragma unroll
  for (int p = 0; p < BS; p += 4) {
    const int b = (p / 4) % 2;
    if (p + 4 < BS) tile_operands<kTrans>(Ts, Ys, r, cc, p + 4, t[b ^ 1], y[b ^ 1]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c)
          acc[i][c] = fmaf(kNeg ? -t[b][i][q] : t[b][i][q], y[b][q][c], acc[i][c]);
  }
}

// The wide walk: one block per strip of 64 columns (16 thread columns of 4,
// 16 thread rows of 4).  The items of the walk, in order: for each block
// row k, the substitutions j (forward: kstart .. k - 1; kTrans: k + 1 ..
// nblk - 1), then the diagonal step, item (k, k).  Item t streams through
// stage t % STAGES: L_kj (L_jk) and X_j, or Inv_kk for the diagonal step,
// whose X half then takes acc.  Items are queued in order, as far ahead as
// the ring allows and no further than the first whose X_j is not written.
template <bool kTrans>
__global__ void __launch_bounds__(NT, 2)
wide_solve_kernel(const float* __restrict__ L, const float* __restrict__ Inv,
                  const float* __restrict__ B, float* __restrict__ X, int M, int Nb,
                  int tril_rhs, int lvec, int xvec) {
  constexpr int LT = BS * LDT;
  constexpr int ST = LT + BS * WW;
  extern __shared__ __align__(16) float wsm[];
  const int tid = threadIdx.x;
  // Warp w covers thread rows 4 (w / 2) .. + 3 and thread columns 8 (w % 2)
  // .. + 7.  Thread row ty holds rows ty + 16 i (forward) or 4 ty + i
  // (kTrans) of each block row, thread column tx columns CW tx .. + CW - 1.
  const int lane = tid % 32, w = tid / 32;
  const int ty = 4 * (w / 2) + lane / 8, tx = 8 * (w % 2) + lane % 8;
  const int r_own = kTrans ? 4 * ty : ty, c_own = CW * tx;
  auto row = [&](int i) { return kTrans ? r_own + i : r_own + 16 * i; };
  const int nblk = (M + BS - 1) / BS;
  // With a triangular right side the strips that start highest (the
  // longest walks) go first: block b takes strip b / runs of run b % runs.
  int strip = blockIdx.x;
  if (tril_rhs && M % WW == 0) {
    const int runs = Nb / M;
    strip = (blockIdx.x % runs) * (M / WW) + blockIdx.x / runs;
  }
  const int c0 = strip * WW;
  const int col = c0 + c_own;
  const int kstart = (!kTrans && tril_rhs) ? first_block(c0, WW, M, Nb) : 0;
  const bool vec_io = xvec && col < Nb;   // CW whole columns inside Nb

  for (int r = ty; r < min(kstart * BS, M); r += 16)
#pragma unroll
    for (int c = 0; c < CW; ++c)
      if (col + c < Nb) X[(size_t)r * Nb + col + c] = 0.f;

  float acc[4][CW];
  auto load_b = [&](int k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = k * BS + row(i);
      if (r < M && vec_io) {
        ld4(B + (size_t)r * Nb + col, acc[i]);
      } else {
#pragma unroll
        for (int c = 0; c < CW; ++c)
          acc[i][c] = (r < M && col + c < Nb) ? B[(size_t)r * Nb + col + c] : 0.f;
      }
    }
  };

  // The walk's cursor (k, j): j == k is the diagonal step.
  auto advance = [&](int& k, int& j) {
    if (!kTrans) {
      if (j < k) ++j;
      else { ++k; j = kstart; }
    } else if (j != k) {
      j = (j + 1 < nblk) ? j + 1 : k;
    } else {
      --k;
      j = k + 1;
    }
  };
  auto in_walk = [&](int k) { return kTrans ? k >= 0 : k < nblk; };
  const int k0 = kTrans ? nblk - 1 : kstart;
  // Block rows written so far: forward rows < done, kTrans rows >= done.
  int done = kTrans ? nblk : kstart;
  auto ready = [&](int k, int j) { return j == k || (kTrans ? j >= done : j < done); };
  auto issue = [&](int k, int j, int t) {
    float* st = wsm + (t % STAGES) * ST;
    if (j == k) {
      load_tile<BS, LDT>(st, Inv + (size_t)k * BS * BS, BS, 0, 0, BS, BS, lvec, tid);
    } else {
      const int rb = kTrans ? j : k, cb = kTrans ? k : j;
      load_tile<BS, LDT>(st, L, M, rb * BS, cb * BS, M, M, lvec, tid);
      load_tile<WW, WW>(st + LT, X, Nb, j * BS, c0, M, Nb, xvec, tid);
    }
    cp_commit();
  };

  int qk = k0, qj = k0, queued = 0;   // the queue's cursor and length
  auto enqueue = [&](int limit) {
    while (queued < limit && in_walk(qk) && ready(qk, qj)) {
      issue(qk, qj, queued++);
      advance(qk, qj);
    }
  };

  load_b(k0);
  int k = k0, j = k0;
  for (int t = 0; in_walk(k); ++t) {
    // Stage t % STAGES last held item t - STAGES, which every thread left
    // before the barrier of item t - 1.
    enqueue(t + 1);
    cp_wait(queued - t - 1);
    __syncthreads();
    // Stages of items < t are free for every thread now.
    enqueue(t + STAGES);
    float* st = wsm + (t % STAGES) * ST;
    if (j != k) {
      tile_product<kTrans, true>(st, st + LT, r_own, c_own, acc);
    } else {
      float* As = st + LT;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c) As[row(i) * WW + c_own + c] = acc[i][c];
      __syncthreads();
      float out[4][CW];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c) out[i][c] = 0.f;
      tile_product<kTrans, false>(st, As, r_own, c_own, out);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = k * BS + row(i);
        if (r >= M) continue;
        float* dst = X + (size_t)r * Nb + col;
        if (vec_io) {
          *reinterpret_cast<float4*>(dst) = make_float4(out[i][0], out[i][1], out[i][2], out[i][3]);
        } else {
#pragma unroll
          for (int c = 0; c < CW; ++c)
            if (col + c < Nb) dst[c] = out[i][c];
        }
      }
      // X_k is written for every thread's later cp.async of it.
      __syncthreads();
      done = kTrans ? k : k + 1;
      if (in_walk(kTrans ? k - 1 : k + 1)) load_b(kTrans ? k - 1 : k + 1);
    }
    advance(k, j);
  }
}

template <bool kTrans>
int solve(const float* L, const float* inv, const float* B, float* X, int M, int Nb,
          int unit_rhs, int tril_rhs, cudaStream_t s) {
  if (unit_rhs || Nb < kWideMinNb) {
    solve_kernel<kTrans><<<(Nb + TW - 1) / TW, NT, 0, s>>>(L, inv, B, X, M, Nb, unit_rhs,
                                                           tril_rhs);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int smem = STAGES * (BS * LDT + BS * WW) * static_cast<int>(sizeof(float));
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(wide_solve_kernel<kTrans>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  auto al16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int lvec = M % 4 == 0 && al16(L) && al16(inv);
  const int xvec = Nb % 4 == 0 && al16(B) && al16(X);
  wide_solve_kernel<kTrans><<<(Nb + WW - 1) / WW, NT, smem, s>>>(L, inv, B, X, M, Nb, tril_rhs,
                                                                  lvec, xvec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Inv [ceil(M / 64), 64, 64], the inverses of the 64x64 diagonal blocks of L
// [M, M] lower (upper triangle ignored), the last block of a ragged M padded
// with the identity: the solves' first launch, and chol.cu's last.
extern "C" int mgp_diag_inv(const void* L, void* inv, int M, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 0)
    diag_inv_kernel<<<(M + BS - 1) / BS, BS, 0, s>>>(static_cast<const float*>(L),
                                                     static_cast<float*>(inv), M);
  return static_cast<int>(cudaGetLastError());
}

// L [M, M] lower (upper triangle ignored), B [M, Nb], X [M, Nb], inv
// [ceil(M / 64), 64, 64]; all fp32 on the device.  With unit_rhs the right
// side is the identity (Nb == M) and B may be null.  With tril_rhs each run
// of M columns of B is lower-triangular (Nb a multiple of M).  With
// inv_given, inv already holds the diagonal-block inverses (the Cholesky
// writes them) and (a) is skipped; otherwise it is scratch that (a) fills.
extern "C" int mgp_trsm_lower(const void* L, void* inv, const void* B, void* X,
                              int M, int Nb, int unit_rhs, int tril_rhs, int inv_given,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 0 && Nb > 0) {
    if (!inv_given) mgp_diag_inv(L, inv, M, stream);
    return solve<false>(static_cast<const float*>(L), static_cast<const float*>(inv),
                        static_cast<const float*>(B), static_cast<float*>(X), M, Nb,
                        unit_rhs, tril_rhs, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// X = L^-T B: L [M, M] lower (upper triangle ignored), B and X [M, Nb], inv
// [ceil(M / 64), 64, 64] given or scratch as above; all fp32 on the device.
extern "C" int mgp_trsm_lower_t(const void* L, void* inv, const void* B, void* X,
                                int M, int Nb, int inv_given, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 0 && Nb > 0) {
    if (!inv_given) mgp_diag_inv(L, inv, M, stream);
    return solve<true>(static_cast<const float*>(L), static_cast<const float*>(inv),
                       static_cast<const float*>(B), static_cast<float*>(X), M, Nb, 0, 0, s);
  }
  return static_cast<int>(cudaGetLastError());
}
