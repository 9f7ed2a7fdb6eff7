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
// in practice by shared-memory bandwidth, below); the inverse (B = I, M^3 / 6
// multiply-adds) and a narrow B (Nb = 8: the bytes of L's triangle) are
// bound by their dependency chain when one block walks a strip: block row k
// needs every X_j above it.  Three launches at most:
//   (a) one CUDA block per 64x64 diagonal block inverts it by substitution
//       in shared memory (a ragged tail is padded with the identity); a
//       caller holding the inverses from the Cholesky (chol.cu, which
//       launches this same kernel through mgp_diag_inv) skips it;
//   (b) the walk over block rows of each column strip of B: acc = B_k -
//       sum_j L_kj X_j, then X_k = Inv_kk acc.  The transposed solve is the
//       same walk from the last block row up, reading L_jk^T; it reuses (a),
//       since the diagonal blocks of L^T have the inverses Inv_kk^T.  Two
//       kernels, chosen by a shape rule in the launcher (kWideMinNb):
//     - wide_solve_kernel (a general B with Nb >= kWideMinNb): one block per
//       64-column strip walks all its block rows (Nb = 8192 is 128 blocks,
//       one wave), a 4x4 register tile a thread, so one 16-byte shared load
//       of L and one of X feed 16 FMAs.  A 16-byte shared load fills four
//       registers of one thread and shared memory delivers 128 bytes a
//       clock, so 8 floats loaded per 16 FMAs hold the SM's 128 FMA lanes to
//       about half their rate: the kernel is bound by shared-memory
//       bandwidth, not by the FMA rate.  (4x2 tiles on 32-column strips,
//       and 8x8 tiles on two block rows at a time with 4 warps an SM, were
//       slower on an H100: PERF.md.)  The (L_kj, X_j) pairs and the Inv_kk
//       tiles stream through a ring of three stages by cp.async (X_j was
//       written by this block one block row earlier, ordered by a
//       __syncthreads after the store); a pair whose X_j is not written yet
//       waits in the queue.  Tiles stay as they lie in memory: the forward
//       reads L_kj along its rows, the transposed walk L_jk along its rows.
//     - wave_solve_kernel (the inverse and a general B with Nb <
//       kWideMinNb): the walk as a dependency graph over the whole card.
//       A work item is (block row k, strip s), X_ks = Inv_kk (B_ks - sum_j
//       L_kj X_js); a persistent grid takes items from a ticket counter
//       (atomicAdd), the tickets numbered by walk row, then by strip (see
//       the item order below), so every item an item waits on holds a
//       smaller ticket: a waiting block waits only on items that are running
//       or done, and the kernel cannot deadlock however few blocks are
//       resident.  An item's L_kj tiles (and Inv_kk) do not depend on X and
//       stream into a ring of stages ahead of time, each half of a stage (L,
//       X) completing its own mbarrier; only X_js waits, on a ready flag per
//       (block row, strip) that its producer sets after storing it
//       (__syncthreads, then one thread's __threadfence and a release
//       store), polled by warp 0 (relaxed loads, a fence on success,
//       __nanosleep between rounds) and read through L2 only (cp.async.cg
//       or ld.global.cg, never L1, which may hold stale lines).  The
//       critical path is then one link per block row (the flag's round
//       trip, the last product and the diagonal step) where a block walking
//       a strip alone chained every product, and the inverse's M^3 / 6 FMAs
//       spread over every SM.  Strips: 64 columns with the wide kernel's
//       4x4 tile product for the inverse and Nb >= kNarrowMaxNb; 8 columns
//       below (Strip<., kNarrowW>), so q_mu's [M, 8] solve is nblk items on
//       nblk SMs instead of one block.  The transposed walk stays a chain
//       whatever the grid: X_k's first term needs X_k+1, the last block
//       row written (see PERF.md for what that costs).
//   Every output keeps one fmaf order (j ascending, p = 0..63 within a
//   tile, then the Inv product from zero) in every kernel and strip width,
//   so all give the same bits as each other and as the 16-column walk they
//   replaced; one item's j-sum is never split.  With B = I (unit_rhs) or a
//   right side that is lower-triangular in each run of M columns (tril_rhs:
//   the unwhitened KL's [M, K*M]) a strip starts at the block row holding
//   its first column, the rows above written as zeros; a strip holding
//   columns of two such runs starts at row 0.  Skipped terms are exact zeros
//   times a finite L, so the result equals the unskipped walk's.
//
// The wavefront's item order (trsm_kernel.wavefront_order computes the
// same): nblk = ceil(M / 64) block rows, nstrips = ceil(Nb / W) strips of W
// columns; kstart(s) = first_block(64 s.. ) when the forward walk skips
// (unit_rhs or tril_rhs), else 0.  Walk rows w = 0 .. nblk - 1 are block
// rows k = w (forward) or nblk - 1 - w (transposed).  The strips sorted
// stably by kstart are perm; walk row w holds the strips with kstart <= k,
// a prefix of perm, and its tickets follow those of row w - 1 in perm's
// order.  The scratch `work` is 1 + nblk * nstrips int32, zero on entry:
// work[0] the ticket counter, work[1 + k * nstrips + s] item (k, s)'s flag.
#include "hopper.cuh"

namespace {

constexpr int BS = 64;        // diagonal block size
constexpr int NT = 256;       // threads per solve block
constexpr int WW = 64;        // columns per wide strip (and the inverse's)
constexpr int CW = WW / 16;   // columns per thread of a 64-column strip (4)
constexpr int STAGES = 3;     // the wide kernel's ring
constexpr int LDT = BS + 4;   // row pitch of a staged L or Inv tile
constexpr int kWideMinNb = 4096;   // a general B at least this wide takes the wide kernel
constexpr int kNarrowW = 8;        // the wavefront's strip below kNarrowMaxNb
constexpr int kNarrowMaxNb = 64;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxPolls = 1 << 22;   // rounds of a wait for one flag (seconds)

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
__host__ __device__ __forceinline__ int first_block(int c0, int w, int M, int Nb) {
  const int lc = c0 % M;
  return (lc + w <= M || c0 - lc + M >= Nb) ? lc / BS : 0;
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
// row stride ld into dst [64][DP] (row pitch DP >= W) by threads tid of
// nthr; rows >= rmax or columns >= cmax read as 0.  vec: ld, c0 and cmax
// multiples of 4 and src 16-byte aligned.
template <int W, int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int ld, int r0,
                                          int c0, int rmax, int cmax, bool vec, int tid,
                                          int nthr = NT) {
  if (vec) {
#pragma unroll
    for (int e = tid; e < BS * W / 4; e += nthr) {
      const int r = e / (W / 4), c = (e % (W / 4)) * 4;
      const bool ok = r0 + r < rmax && c0 + c < cmax;
      cp_async16(dst + r * DP + c, ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
    }
  } else {
    for (int e = tid; e < BS * W; e += nthr) {
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


// --- the wavefront kernel.

// Arrive on `bar` once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void cp_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The thread tiles of a strip of W columns: rows row(i), i < R, and
// columns col(c), c < C, of each 64-row block for the threads with
// active(); product<kNeg>(Ts, Ys, acc)
// adds (or subtracts) sum_p T[row][p] Y[p][col], p = 0..63 in order, one
// fmaf each, T as tile_product reads it.
template <bool kTrans, int W>
struct Strip;

// 64 columns: the wide kernel's 4x4 tiles and warp layout.
template <bool kTrans>
struct Strip<kTrans, WW> {
  static constexpr int R = 4, C = CW, G = 1, NS = 3;   // G: block rows a step; NS: stages
  static constexpr int LP = LDT, LT = BS * LDT;        // T tiles [64][LDT]
  static constexpr bool kTma = false;
  static constexpr int L0 = 0, LN = NT, X0 = 0, XN = NT;   // every thread copies, arrives
  int r_own, c_own;
  __device__ explicit Strip(int tid) {
    const int lane = tid % 32, w = tid / 32;
    const int ty = 4 * (w / 2) + lane / 8, tx = 8 * (w % 2) + lane % 8;
    r_own = kTrans ? 4 * ty : ty;
    c_own = CW * tx;
  }
  __device__ bool active() const { return true; }
  __device__ int row(int i) const { return kTrans ? r_own + i : r_own + 16 * i; }
  __device__ int col(int c) const { return c_own + c; }
  template <bool kNeg>
  __device__ void product(const float* Ts, const float* Ys, float (&acc)[R][C]) const {
    tile_product<kTrans, kNeg>(Ts, Ys, r_own, c_own, acc);
  }
};

// 8 columns: threads 0 .. 127 each hold four rows of column tx (ty = tid /
// 8, tx = tid % 8): 4 ty .. 4 ty + 3 transposed, ty + 16 i forward; the
// others copy and wait.  A product is bound by shared-memory bandwidth: one
// 16-byte load of T (four rows at one p transposed, one row at four p
// forward) per four FMAs, free of bank conflicts (two rows a thread on 256
// threads, three loads per two FMAs, was slower on an H100: PERF.md).
//   The transposed walk, whose every step is on the chain, takes G = 4
// block rows a step, L_jk .. L_j+3,k as one 256 x 64 TMA box (dense rows,
// read down a column) issued by one thread, so a step's fixed costs
// (barriers, the ring's mbarriers) are paid once for four products.  The
// forward walk reads T along rows, which a dense 64-float pitch puts in one
// bank: its tiles keep the pitch LDT, copied by warps 4 and 5 (cp.async;
// 256 threads arriving on one mbarrier stalled every step on an H100).
// X comes by the last warp's cp.async either way.
template <bool kTrans>
struct Strip<kTrans, kNarrowW> {
  static constexpr int R = 4, C = 1, G = kTrans ? 4 : 1, NS = kTrans ? 3 : 10;
  static constexpr int LP = kTrans ? BS : LDT;   // T's row pitch
  static constexpr int LT = G * BS * LP;
  static constexpr bool kTma = kTrans;
  static constexpr int L0 = 128, LN = kTrans ? 1 : 64;   // threads copying L; arrivals
  static constexpr int X0 = NT - 32, XN = 32;            // the same for X
  int ty, tx;
  __device__ explicit Strip(int tid) : ty(tid / kNarrowW), tx(tid % kNarrowW) {}
  __device__ bool active() const { return ty < BS / R; }
  __device__ int row(int i) const { return kTrans ? R * ty + i : ty + 16 * i; }
  __device__ int col(int) const { return tx; }
  template <bool kNeg>
  __device__ void product(const float* Ts, const float* Ys, float (&acc)[R][C]) const {
#pragma unroll 4
    for (int p = 0; p < BS; p += 4) {
      float t[4][R], y[4];   // t[q][i] = T[row(i)][p + q]
#pragma unroll
      for (int q = 0; q < 4; ++q) y[q] = Ys[(p + q) * kNarrowW + tx];
      if (kTrans) {
#pragma unroll
        for (int q = 0; q < 4; ++q) ld4(Ts + (p + q) * LP + R * ty, t[q]);
      } else {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float v[4];
          ld4(Ts + row(i) * LP + p, v);
#pragma unroll
          for (int q = 0; q < 4; ++q) t[q][i] = v[q];
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][0] = fmaf(kNeg ? -t[q][i] : t[q][i], y[q], acc[i][0]);
    }
  }
};

// Rows r0 .. r0 + 63, columns c0 .. c0 + W - 1 of X [M, Nb] into dst [64][W]
// by plain loads through L2 (ld.global.cg), for rows not 16-byte aligned;
// past M or Nb reads as 0.
template <int W>
__device__ __forceinline__ void load_x_cg(float* dst, const float* X, int r0, int c0, int M,
                                          int Nb, int tid) {
  for (int e = tid; e < BS * W; e += NT) {
    const int r = r0 + e / W, c = c0 + e % W;
    dst[e] = (r < M && c < Nb) ? __ldcg(X + (size_t)r * Nb + c) : 0.f;
  }
}

// The wavefront walk (see the top of this file): a persistent grid, each
// block taking items (k, s) by ticket.  Item (k, s) subtracts L_kj X_js for
// its dependencies j in order (forward: kstart .. k - 1; kTrans: k + 1 ..
// nblk - 1), G of them a step, then takes the diagonal product.  A block's
// step g streams through stage g % NS: the L half (L_kj .., or Inv_kk) as
// soon as the stage is free, the X half once its flags are seen; each step
// waits on the two halves' mbarriers (phase parity g / NS).
template <bool kTrans, int W>
__global__ void __launch_bounds__(NT, W == WW ? 2 : 1)   // two 64-column blocks an SM
wave_solve_kernel(const __grid_constant__ CUtensorMap mapL,
                  const __grid_constant__ CUtensorMap mapInv, const float* __restrict__ L,
                  const float* __restrict__ Inv, const float* __restrict__ B,
                  float* __restrict__ X, int* __restrict__ work, int M, int Nb, int unit_rhs,
                  int skip, int lvec, int xvec) {
  using S = Strip<kTrans, W>;
  constexpr int R = S::R, C = S::C, NS = S::NS;
  constexpr int LT = S::LT;
  constexpr int ST = LT + S::G * BS * W;
  extern __shared__ __align__(16) float wsm_raw[];
  // 128-byte aligned for TMA, by an offset into the shared array (a pointer
  // rebuilt from an integer is generic, and every load through it too: the
  // products then ran much slower on an H100).
  float* wsm = wsm_raw + ((128 - (smem_u32(wsm_raw) & 127)) & 127) / sizeof(float);
  __shared__ int s_item[3];   // the ticket's k and s; the deps known ready
  const int tid = threadIdx.x, lane = tid % 32;
  const int nblk = (M + BS - 1) / BS, nstrips = (Nb + W - 1) / W;
  // After the ring: per stage an mbarrier for its L (or Inv) half and one
  // for its X half, each completed by every thread's arrival; then the
  // item tables.
  uint64_t* lbar = reinterpret_cast<uint64_t*>(wsm + NS * ST);
  uint64_t* xbar = lbar + NS;
  int* rs = reinterpret_cast<int*>(xbar + NS);      // walk row -> its first ticket
  int* perm = rs + nblk + 1;                        // strips by kstart, stable
  int* flags = work + 1;
  const S th(tid);
  auto kstart = [&](int s) { return skip ? first_block(s * W, W, M, Nb) : 0; };

  if (tid == 0) {
    for (int q = 0; q < NS; ++q) {
      mgp::mbar_init(&lbar[q], S::kTma && lvec ? 1 : S::LN);
      mgp::mbar_init(&xbar[q], S::XN);
    }
    for (int k = 0; k <= nblk; ++k) rs[k] = 0;
    for (int s = 0; s < nstrips; ++s) ++rs[kstart(s) + 1];
    for (int k = 0; k < nblk; ++k) rs[k + 1] += rs[k];      // rs[k]: strips with kstart < k
    for (int s = 0; s < nstrips; ++s) perm[rs[kstart(s)]++] = s;
    int total = 0;                                           // rs[k]: strips with kstart <= k
    for (int w = 0; w < nblk; ++w) {
      const int n = kTrans ? nstrips : rs[w];
      rs[w] = total;
      total += n;
    }
    rs[nblk] = total;
  }
  // Rows above a strip's first block row are zeros, shared out over the grid.
  if (skip)
    for (int s = 0; s < nstrips; ++s) {
      const int nr = min(kstart(s) * BS, M);
      for (int e = tid;; e += NT) {
        const int r = blockIdx.x + (e / W) * gridDim.x, c = s * W + e % W;
        if (r >= nr) break;
        if (c < Nb) X[(size_t)r * Nb + c] = 0.f;
      }
    }

  int g0 = 0;   // this block's steps so far: step q of an item is its step g0 + q
  for (;;) {
    __syncthreads();   // the tables and barriers are set; s_item is free
    if (tid == 0) {
      const int t = atomicAdd(work, 1);
      int k = -1, s = 0;
      if (t < rs[nblk]) {
        int lo = 0, hi = nblk - 1;   // the last walk row starting at or before t
        while (lo < hi) {
          const int mid = (lo + hi + 1) / 2;
          if (rs[mid] <= t) lo = mid;
          else hi = mid - 1;
        }
        s = perm[t - rs[lo]];
        k = kTrans ? nblk - 1 - lo : lo;
      }
      s_item[0] = k;
      s_item[1] = s;
    }
    __syncthreads();
    const int k = s_item[0], s = s_item[1];
    if (k < 0) break;
    const int c0 = s * W;
    const int ks = kstart(s);
    const int ndeps = kTrans ? nblk - 1 - k : k - ks;
    auto dep = [&](int i) { return kTrans ? k + 1 + i : ks + i; };

    float acc[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int r = k * BS + th.row(i), col = c0 + th.col(c);
        if (!th.active()) acc[i][c] = 0.f;
        else if (unit_rhs) acc[i][c] = (r == col) ? 1.f : 0.f;
        else acc[i][c] = (r < M && col < Nb) ? __ldg(B + (size_t)r * Nb + col) : 0.f;
      }

    // Step q < last covers deps G q .. G q + G - 1 (those below ndeps), step
    // last the diagonal.  Its halves each complete its stage's barrier: L_kj
    // (L_jk) or Inv_kk as soon as the stage is free, X_js once its flags are
    // seen (the diagonal step loads no X and only arrives).  The copying
    // threads (Strip's L0 / LN, X0 / XN) arrive once each; TMA's one thread
    // expects the bytes; where rows are not 16-byte aligned every thread
    // copies, then one barrier and LN arrivals.
    constexpr int G = S::G, LP = S::LP;
    const int last = (ndeps + G - 1) / G;
    auto stage_of = [&](int q) { return (g0 + q) % NS; };
    auto deps_to = [&](int q) { return min(ndeps, G * (q + 1)); };   // deps of steps <= q
    auto issue_l = [&](int q) {
      float* st = wsm + stage_of(q) * ST;
      uint64_t* bar = &lbar[stage_of(q)];
      // L_kj, or L_jk transposed (its columns lie inside M), or Inv_kk.
      const int rb = q == last ? 0 : kTrans ? dep(G * q) : k;
      const int cb = q == last ? 0 : kTrans ? k : dep(G * q);
      const float* src = q == last ? Inv + (size_t)k * BS * BS : L;
      const int ld = q == last ? BS : M, rmax = q == last ? BS : M;
      if (S::kTma && lvec) {   // one box; rows past M read as 0
        if (tid == 0) {
          mgp::mbar_expect_tx(bar, (q == last ? 1 : G) * BS * BS * sizeof(float));
          if (q == last) mgp::tma_load_2d(st, &mapInv, bar, 0, k * BS);
          else mgp::tma_load_2d(st, &mapL, bar, cb * BS, rb * BS);
        }
        return;
      }
      const bool all = S::kTma;   // the unaligned fallback of the TMA strip
      const int t = tid - (all ? 0 : S::L0), n = all ? NT : S::LN;
      if (t >= 0 && t < n)
        for (int g = 0; g < (q == last ? 1 : G); ++g)
          load_tile<BS, LP>(st + g * BS * LP, src, ld, (rb + g) * BS, cb * BS, rmax, rmax,
                            lvec, t, n);
      if (!all) {
        if (tid >= S::L0 && tid < S::L0 + S::LN) cp_arrive(bar);
        return;
      }
      cp_commit();
      cp_wait(0);
      __syncthreads();
      if (tid == S::L0) mgp::mbar_arrive(bar);
    };
    auto issue_x = [&](int q) {
      float* st = wsm + stage_of(q) * ST + LT;
      uint64_t* bar = &xbar[stage_of(q)];
      const int r0 = dep(min(G * q, ndeps - 1)) * BS;
      if (q < last && !xvec) {   // every thread, then one barrier
        for (int g = 0; g < G; ++g)
          load_x_cg<W>(st + g * BS * W, X, r0 + g * BS, c0, M, Nb, tid);
        if (S::XN != NT) __syncthreads();
      }
      if (tid < S::X0 || tid >= S::X0 + S::XN) return;
      if (q == last || !xvec) {
        mgp::mbar_arrive(bar);
        return;
      }
      for (int e = tid - S::X0; e < G * BS * W / 4; e += S::XN) {   // past M or Nb: 0
        const int r = e / (W / 4), c = (e % (W / 4)) * 4;
        const bool ok = r0 + r < M && c0 + c < Nb;
        cp_async16(st + r * W + c, ok ? X + (size_t)(r0 + r) * Nb + c0 + c : X, ok);
      }
      cp_arrive(bar);
    };

    int known = 0;          // warp 0: the leading deps whose flags it has seen
    int lq = 0, xq = 0;     // the steps whose L and X halves are issued
    for (int i = 0; i <= last; ++i) {
      // Warp 0 learns which X_js are written when the ring could take one
      // it does not know of: up to 32 flags a round, one load a lane,
      // waiting only for step i's own.
      const int need = deps_to(i);
      if (tid < 32 && known < deps_to(i + NS - 1)) {
        const int before = known;
        for (int round = 0;; ++round) {
          const int q = known + lane;
          const int v = q < ndeps ? ld_relaxed(flags + dep(q) * nstrips + s) : 1;
          const unsigned unset = __ballot_sync(0xffffffffu, v == 0);
          known = min(ndeps, unset ? known + __ffs(unset) - 1 : known + 32);
          if (known >= need) break;
          if (round == kMaxPolls) __trap();   // a flag never set: fail, never hang
          __nanosleep(128);
        }
        if (known > before) __threadfence();   // acquire what the flags release
        if (lane == 0) s_item[2] = known;
      }
      __syncthreads();   // step i - 1's stage is free; the flags seen are shared
      const int ready = s_item[2];   // read only while xq < last
      for (; lq <= last && lq < i + NS; ++lq) issue_l(lq);
      for (; xq < lq && (xq == last || deps_to(xq) <= ready); ++xq) issue_x(xq);
      const uint32_t parity = ((g0 + i) / NS) & 1;
      float* st = wsm + stage_of(i) * ST;
      mgp::mbar_wait(&lbar[stage_of(i)], parity);
      if (i < last) {
        mgp::mbar_wait(&xbar[stage_of(i)], parity);
        if (th.active())
          for (int g = 0; g < deps_to(i) - G * i; ++g)
            th.template product<true>(st + g * BS * BS, st + LT + g * BS * W, acc);
        continue;
      }
      // The diagonal step: X_ks = Inv_kk acc (Inv_kk^T acc transposed).
      float* As = st + LT;
      if (th.active())
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c) As[th.row(r) * W + th.col(c)] = acc[r][c];
      __syncthreads();
      float out[R][C];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) out[r][c] = 0.f;
      if (th.active()) th.template product<false>(st, As, out);
#pragma unroll
      for (int r = 0; r < R && th.active(); ++r) {
        const int row = k * BS + th.row(r);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int col = c0 + th.col(c);
          if (row < M && col < Nb) X[(size_t)row * Nb + col] = out[r][c];
        }
      }
      __syncthreads();   // every store of X_ks is made before the flag
      if (tid == 0) {
        __threadfence();
        st_release(flags + k * nstrips + s, 1);
      }
    }
    g0 += last + 1;
  }
}

// Items of the wavefront walk (the grid is never larger).
int wave_items(int M, int Nb, int W, bool skip) {
  const int nblk = (M + BS - 1) / BS, nstrips = (Nb + W - 1) / W;
  if (!skip) return nblk * nstrips;
  int n = 0;
  for (int s = 0; s < nstrips; ++s) n += nblk - first_block(s * W, W, M, Nb);
  return n;
}

template <bool kTrans, int W>
int wave_solve(const float* L, const float* inv, const float* B, float* X, int* work, int M,
               int Nb, int unit_rhs, int skip, int lvec, int xvec, cudaStream_t s) {
  using Sp = Strip<kTrans, W>;
  const int nblk = (M + BS - 1) / BS, nstrips = (Nb + W - 1) / W;
  const size_t smem = 128 + (size_t)Sp::NS * (Sp::LT + Sp::G * BS * W) * sizeof(float) +
                      2 * Sp::NS * sizeof(uint64_t) + (size_t)(nblk + 1 + nstrips) * sizeof(int);
  // The 8-column strip reads L and Inv through TMA maps (one box a step: G
  // tiles of L, or Inv_kk) where their rows are 16-byte aligned; the other
  // strip leaves them unread.
  CUtensorMap mapL{}, mapInv{};
  auto map2d = [](CUtensorMap* map, const void* base, int cols, int rows, int box_cols,
                  int box_rows) {
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
    return mgp::encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, base, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
  };
  if (Sp::kTma && lvec && (!map2d(&mapL, L, M, M, BS, Sp::G * BS) ||
                           !map2d(&mapInv, inv, BS, nblk * BS, BS, BS)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = wave_solve_kernel<kTrans, W>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 1, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = wave_items(M, Nb, W, skip != 0);
  const int grid = items < per_sm * sms ? items : per_sm * sms;
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<grid, NT, smem, s>>>(mapL, mapInv, L, inv, B, X, work, M, Nb, unit_rhs, skip, lvec,
                                xvec);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTrans>
int solve(const float* L, const float* inv, const float* B, float* X, int* work, int M, int Nb,
          int unit_rhs, int tril_rhs, cudaStream_t s) {
  auto al16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int lvec = M % 4 == 0 && al16(L) && al16(inv);
  const int xvec = Nb % 4 == 0 && (unit_rhs || al16(B)) && al16(X);
  if (unit_rhs || Nb < kWideMinNb) {
    const int skip = !kTrans && (unit_rhs || tril_rhs);
    if (!unit_rhs && Nb < kNarrowMaxNb)
      return wave_solve<kTrans, kNarrowW>(L, inv, B, X, work, M, Nb, unit_rhs, skip, lvec, xvec, s);
    return wave_solve<kTrans, WW>(L, inv, B, X, work, M, Nb, unit_rhs, skip, lvec, xvec, s);
  }
  constexpr int smem = STAGES * (BS * LDT + BS * WW) * static_cast<int>(sizeof(float));
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(wide_solve_kernel<kTrans>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
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
// work: the wavefront's int32 scratch (see the top of this file), zero on
// entry; unread when the wide kernel runs.
extern "C" int mgp_trsm_lower(const void* L, void* inv, const void* B, void* X, void* work,
                              int M, int Nb, int unit_rhs, int tril_rhs, int inv_given,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 0 && Nb > 0) {
    if (!inv_given) mgp_diag_inv(L, inv, M, stream);
    return solve<false>(static_cast<const float*>(L), static_cast<const float*>(inv),
                        static_cast<const float*>(B), static_cast<float*>(X),
                        static_cast<int*>(work), M, Nb, unit_rhs, tril_rhs, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// X = L^-T B: L [M, M] lower (upper triangle ignored), B and X [M, Nb], inv
// [ceil(M / 64), 64, 64] given or scratch and work as above; all on the
// device.
extern "C" int mgp_trsm_lower_t(const void* L, void* inv, const void* B, void* X, void* work,
                                int M, int Nb, int inv_given, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 0 && Nb > 0) {
    if (!inv_given) mgp_diag_inv(L, inv, M, stream);
    return solve<true>(static_cast<const float*>(L), static_cast<const float*>(inv),
                       static_cast<const float*>(B), static_cast<float*>(X),
                       static_cast<int*>(work), M, Nb, 0, 0, s);
  }
  return static_cast<int>(cudaGetLastError());
}
