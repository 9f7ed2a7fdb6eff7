// Lower Cholesky factor L of an SPD [M, M] f32 matrix and the inverses of
// its 64x64 diagonal blocks, by a right-looking blocked factorization run as
// one persistent kernel over a task graph.
//
// Replaces modulatedgps_tpu/ops/pallas_linalg.py:_chol_kernel (the whole
// matrix resident in VMEM, M <= 1024) and _chol_kernel_large (the same loop
// at M = 4096 with a DMA'd input and dynamic loop bounds).  On the TPU they
// were two kernels only because of VMEM; here one C entry serves every M.
//
// Bound on the H100: M^3 / 3 fp32 operations (2.3e10 at M = 4096, 0.34 ms
// at the 67 TFLOP/s fp32 peak) against 2 * 4 * M^2 bytes (0.04 ms), so
// arithmetic in principle.  In practice the 64 block columns form a serial
// chain -- factor a diagonal tile, solve the tile below it, update the next
// diagonal tile -- and a host loop of one launch per kernel per block
// column (193 launches at M = 4096) left every SM but one idle while a
// diagonal tile factored.  fp32 FMAs only: the TPU ran every dot at HIGHEST,
// and anything that feeds the Cholesky stays full fp32 (never TF32).
//
// Design: chol_copy_kernel writes L = tril(A) and zeroes the task state;
// then chol_dag_kernel, two CTAs per SM, runs the factorization as 64x64
// tile tasks, each waiting (acquire loads, one warp per input) on per-tile
// counters until its inputs are final:
//   diag(j)       the chain's link, all run by CTA 0 in j order: solve the
//                 panel tile (j, j - 1) against L_{j-1,j-1}, which CTA 0
//                 factored last and still holds in shared memory, publish it,
//                 apply its update to tile (j, j), then factor that tile;
//                 the pool CTA that lands on CTA 0's SM leaves at once, so
//                 the chain has its SM to itself;
//   panel(i, j)   P_ij L_jj^T = A_ij by substitution for i >= j + 2;
//   update(i,k,j) A_ik -= P_ij P_kj^T for j < k <= i, (i, k) != (j+1, j+1):
//                 256 threads of 4x4 register tiles over the two operands
//                 staged transposed in shared memory.
// The other CTAs (the pool) take the panels and updates in a fixed order
// from an atomic counter, one task ahead.  The order gives a lookahead of one
// block column: step j's updates of block column j + 1 come first in its
// group, so diag(j + 1) can start while the rest of step j's trailing update
// goes on.  Every dependency of a pool task comes earlier in the order or is
// a diag, whose own dependencies come earlier still, and a task is taken
// only by a running CTA, so the spins cannot deadlock.  A tile's updates
// come in j order and every sum in a fixed order, so the factor's bits do
// not depend on the schedule or the number of CTAs.
// The diagonal tile factors in four blocks of 16 columns, three block
// barriers each (factor_tile); the substitution keeps a row's 16 columns per
// thread in registers, rotated one block of 4 at a time so that every
// register index is a constant.  Both do, entry by entry, the FMAs of a
// column-by-column factor in its order, so L is bit-equal to the host-loop
// kernel this one replaced.  Tile data written by one CTA and read by another
// go through L2 (ld.global.cg / st.global.cg), published by a block barrier,
// a fence and a release store of the counter.  state[i][k] counts what tile
// (i, k) has received: j updates, then (for k == j) its factor or panel
// solve, j + 1.
// After the graph, trsm.cu's own diag_inv_kernel (through mgp_diag_inv)
// inverts every diagonal block at once, so Inv is by construction what a
// solve would compute from L.  Three launches a factorization.  A ragged M
// is padded with the identity inside diag (and the inverse) and masked in
// panel and update.  A pivot that is not positive (or NaN) becomes NaN,
// which then fills every later column, as jnp.linalg.cholesky gives NaN:
// no host sync reads an info code.
#include <cuda_runtime.h>

// trsm.cu: the inverses of L's 64x64 diagonal blocks, its solves' first launch.
extern "C" int mgp_diag_inv(const void* L, void* inv, int M, void* stream);

namespace {

constexpr int BS = 64;          // block size (trsm.cu's diagonal block size)
constexpr int NT = 256;         // threads per CTA
constexpr int FB = 16;          // column block of the diagonal tile's factor
constexpr int LDT = BS + 4;     // row pitch of the transposed tiles (float4 aligned)
constexpr int LDS = BS + 1;     // row pitch of the row-major tiles
constexpr unsigned FULL = 0xffffffffu;

enum Task { kDiag, kPanel, kUpdate };

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int sm_id() {
  int v;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(v));
  return v;
}

__device__ __forceinline__ void wait_ge(const int* p, int v) {
  while (ld_acquire(p) < v) __nanosleep(32);
}

// Publish tile (i, k)'s counter once every thread's stores are visible: the
// block barrier orders them before thread 0's fence and release store (the
// pattern of a cooperative grid barrier).
__device__ __forceinline__ void release(int* counter, int v) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(counter, v);
  }
}

// The pool's tasks, group by group: g = -1 holds the panels (i, 0), i >= 2;
// group g >= 0 holds step g's updates of block column g + 1 (tiles (i, g +
// 1), i >= g + 2), the panels (i, g + 1), i >= g + 3, and step g's remaining
// updates (block columns g + 2 on, column by column).
__host__ __device__ inline long long group_size(int g, int nblk) {
  if (g < 0) return nblk > 2 ? nblk - 2 : 0;
  const long long n = nblk - 2 - g;        // updates of column g + 1; the rest's side
  return n + (n > 1 ? n - 1 : 0) + n * (n + 1) / 2;
}

// L = tril(A), exact zeros above the diagonal: the working copy; and the
// task counter and tile counters set to 0.
__global__ void chol_copy_kernel(const float* __restrict__ A, float* __restrict__ L,
                                 int M, int* __restrict__ work, int nwork) {
  const size_t total = (size_t)M * M;
  const size_t stride = (size_t)gridDim.x * NT;
  const size_t first = blockIdx.x * (size_t)NT + threadIdx.x;
  for (size_t e = first; e < total; e += stride) {
    const int r = (int)(e / M), c = (int)(e % M);
    L[e] = (c <= r) ? A[e] : 0.f;
  }
  for (size_t e = first; e < (size_t)nwork; e += stride) work[e] = 0;
}

// Column blocks cb0 .. cb0 + 3 of panel_solve, with only the QMAX
// registers that can still hold a live column (a[q], q < 16 - cb).
template <int QMAX>
__device__ __forceinline__ void panel_blocks(float (&a)[BS / 4], int cb0, float (*x)[LDS],
                                             float (*l)[LDT], const float* rdiag) {
  const int tid = threadIdx.x;
  const int r = tid >> 2, part = tid & 3, lane = tid & 31;
  for (int cb = cb0; cb < cb0 + 4; ++cb) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = 4 * cb + u;
      const float xv = __shfl_sync(FULL, a[0] * rdiag[c], (lane & ~3) | u);
      if (part == u) a[0] = xv;
      else if (part > u) a[0] = fmaf(-xv, l[4 * cb + part][c], a[0]);
#pragma unroll
      for (int q = 1; q < QMAX; ++q)     // past column 63: dead registers
        a[q] = fmaf(-xv, l[(4 * (cb + q) + part) & (BS - 1)][c], a[q]);
    }
    x[r][4 * cb + part] = a[0];
#pragma unroll
    for (int q = 0; q < QMAX - 1; ++q) a[q] = a[q + 1];
  }
}

// P = X L_jj^-T in place for the tile x [64][LDS] (rows past `rows` are 0),
// l = L_jj [64][LDT], rdiag = 1 / diag(L_jj).  Thread (r, part) = (tid / 4,
// tid % 4) holds columns 4 q + part of row r in a[q]; column step c = 4 cb
// + u: P[r][c] = x_rc / L_jj[c][c] from its owner (part u) by a shuffle
// inside the four, then every later column folds it in, x_rc' = fma(-P[r][c],
// L_jj[c'][c], x_rc').  After each block of 4 columns the registers rotate
// by one, so the block's own columns sit in a[0].  Writes P back into x.
__device__ void panel_solve(float (*x)[LDS], float (*l)[LDT], const float* rdiag) {
  const int tid = threadIdx.x;
  float a[BS / 4];
#pragma unroll
  for (int q = 0; q < BS / 4; ++q) a[q] = x[tid >> 2][4 * q + (tid & 3)];
  panel_blocks<16>(a, 0, x, l, rdiag);
  panel_blocks<12>(a, 4, x, l, rdiag);
  panel_blocks<8>(a, 8, x, l, rdiag);
  panel_blocks<4>(a, 12, x, l, rdiag);
}

// Stage L_jj (pitch LDT) and 1 / its diagonal.
__device__ void stage_ljj(const float* __restrict__ L, int M, int j, float (*l)[LDT],
                          float* rdiag) {
  const float* Ljj = L + (size_t)j * BS * M + (size_t)j * BS;
  float v[BS * BS / NT];         // every load in flight before the first store
#pragma unroll
  for (int q = 0; q < BS * BS / NT; ++q) {
    const int e = threadIdx.x + q * NT;
    v[q] = __ldcg(Ljj + (size_t)(e / BS) * M + e % BS);   // j < nblk - 1: inside M
  }
  const float diag = threadIdx.x < BS ? __ldcg(Ljj + (size_t)threadIdx.x * M + threadIdx.x) : 1.f;
#pragma unroll
  for (int q = 0; q < BS * BS / NT; ++q) {
    const int e = threadIdx.x + q * NT;
    l[e / BS][e % BS] = v[q];
  }
  if (threadIdx.x < BS) rdiag[threadIdx.x] = 1.f / diag;
}

// Stage tile (i, j) row-major (pitch LDS), rows past M as 0.
__device__ void stage_tile(const float* __restrict__ L, int M, int i, int j,
                           float (*x)[LDS]) {
  const int rows = min(BS, M - i * BS);
  const float* T = L + (size_t)i * BS * M + (size_t)j * BS;
  float v[BS * BS / NT];
#pragma unroll
  for (int q = 0; q < BS * BS / NT; ++q) {
    const int e = threadIdx.x + q * NT;
    v[q] = (e / BS < rows) ? __ldcg(T + (size_t)(e / BS) * M + e % BS) : 0.f;
  }
#pragma unroll
  for (int q = 0; q < BS * BS / NT; ++q) {
    const int e = threadIdx.x + q * NT;
    x[e / BS][e % BS] = v[q];
  }
}

// Write the rows of x that lie inside M back to tile (i, j).
__device__ void store_tile(float* __restrict__ L, int M, int i, int j, float (*x)[LDS]) {
  const int rows = min(BS, M - i * BS);
  float* T = L + (size_t)i * BS * M + (size_t)j * BS;
#pragma unroll
  for (int q = 0; q < BS * BS / NT; ++q) {
    const int e = threadIdx.x + q * NT;
    const int r = e / BS, c = e % BS;
    if (r < rows) __stcg(T + (size_t)r * M + c, x[r][c]);
  }
}

// acc[ii][c] = sum_p At[p][ty * 4 + ii] * Bt[p][tx * 4 + c] in p order:
// thread (tx, ty) = (tid % 16, tid / 16)'s 4x4 block of A B^T from the
// transposed operands.
__device__ __forceinline__ void product_4x4(float (*At)[LDT], float (*Bt)[LDT],
                                            float (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[ii][c] = 0.f;
#pragma unroll 8
  for (int p = 0; p < BS; ++p) {
    const float4 a = *reinterpret_cast<const float4*>(&At[p][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&Bt[p][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[ii][c] = fmaf(av[ii], bv[c], acc[ii][c]);
  }
}

// Factor the tile s [64][LDS] in place (lower triangle read and written;
// the upper one is left as it is), in four blocks of FB = 16 columns, three
// block barriers each.  For the block at column c0: (1) warp 0 factors the
// diagonal block D in registers, lane l holding row c0 + l (l < 16), the
// pivot and column k's entries passed by shuffles, and every lane computing
// sqrt(pivot) and its inverse itself; (2) one thread per row below D solves
// its 16 entries against D; (3) four threads per trailing row fold the
// block's 16 columns into the entries right of it, k in order.  Each entry
// (r, c) thus takes a_rc = fma(-l_rk, l_ck, a_rc) for k = 0, 1, ... and then
// l_rc = a_rc * (1 / l_cc), with l_rk = a_rk * (1 / l_kk) and l_kk =
// sqrt(a_kk): the arithmetic, in the order, of a column-by-column factor.
// rd [FB] holds the block's inverse pivots.
__device__ void factor_tile(float (*s)[LDS], float* rd) {
  const int tid = threadIdx.x, lane = tid & 31;
  __syncthreads();
  for (int c0 = 0; c0 < BS; c0 += FB) {
    if (tid < 32) {                           // (1) the diagonal block
      const int l = lane & (FB - 1);
      float x[FB];
#pragma unroll
      for (int q = 0; q < FB; ++q) x[q] = s[c0 + l][c0 + q];
#pragma unroll
      for (int k = 0; k < FB; ++k) {
        const float pivot = __shfl_sync(FULL, x[k], k);
        const float d = (pivot > 0.f) ? sqrtf(pivot) : nan_f();
        const float rdk = 1.f / d;
        const float lrk = x[k] * rdk;
#pragma unroll
        for (int c = k + 1; c < FB; ++c) {
          const float lck = __shfl_sync(FULL, x[k], c) * rdk;
          if (c <= l) x[c] = fmaf(-lrk, lck, x[c]);
        }
        if (l > k) x[k] = lrk;
        else if (l == k) x[k] = d;
        if (lane == k) rd[k] = rdk;
      }
      if (lane < FB) {
#pragma unroll
        for (int q = 0; q < FB; ++q)
          if (q <= l) s[c0 + l][c0 + q] = x[q];
      }
    }
    __syncthreads();
    const int below = BS - c0 - FB;           // rows under D
    if (tid < below) {                        // (2) the panel under D
      const int r = c0 + FB + tid;
      float x[FB];
#pragma unroll
      for (int q = 0; q < FB; ++q) x[q] = s[r][c0 + q];
#pragma unroll
      for (int k = 0; k < FB; ++k) {
        x[k] *= rd[k];
#pragma unroll
        for (int c = k + 1; c < FB; ++c) x[c] = fmaf(-x[k], s[c0 + c][c0 + k], x[c]);
      }
#pragma unroll
      for (int q = 0; q < FB; ++q) s[r][c0 + q] = x[q];
    }
    __syncthreads();
    if (tid < 4 * below) {                    // (3) the trailing update
      const int r = c0 + FB + (tid >> 2);
      float lr[FB];
#pragma unroll
      for (int q = 0; q < FB; ++q) lr[q] = s[r][c0 + q];
      for (int c = c0 + FB + (tid & 3); c <= r; c += 4) {
        float a = s[r][c];
#pragma unroll
        for (int k = 0; k < FB; ++k) a = fmaf(-lr[k], s[c][c0 + k], a);
        s[r][c] = a;
      }
    }
    __syncthreads();
  }
}

struct DiagSmem {
  float l[BS][LDT];      // L_{j-1,j-1}, then P_{j,j-1} transposed
  float x[BS][LDS];      // the panel tile, then the diagonal tile
  float rdiag[BS];
  float rd[FB];          // the factor's inverse pivots, one block at a time
};

// diag(j): for j > 0, solve the panel tile (j, j - 1) against L_{j-1,j-1}
// (left in sm.l and sm.rdiag by diag(j - 1)), publish it, apply its update
// P P^T to tile (j, j) (the last one that tile receives); then factor tile
// (j, j), padded with the identity past M, and leave it in sm.l and its
// inverse diagonal in sm.rdiag for diag(j + 1).
__device__ void diag_task(float* __restrict__ L, int M, int j, int* state, int nblk,
                          DiagSmem& sm, unsigned long long* part) {
  const int tid = threadIdx.x;
  const int base = j * BS;
  const int rows = min(BS, M - base);
  float acc[4][4];
  const unsigned long long t0 = now_ns();
  unsigned long long t1 = t0, t2 = t0;
  if (j > 0) {
    stage_tile(L, M, j, j - 1, sm.x);
    __syncthreads();
    panel_solve(sm.x, sm.l, sm.rdiag);
    __syncthreads();
    store_tile(L, M, j, j - 1, sm.x);
#pragma unroll
    for (int q = 0; q < BS * BS / NT; ++q) {   // P transposed (rows past M are 0)
      const int e = tid + q * NT;
      const int rr = e / BS, p = e % BS;
      sm.l[p][rr] = sm.x[rr][p];
    }
    release(state + j * nblk + j - 1, j);
    t1 = now_ns();
    product_4x4(sm.l, sm.l, acc);
    t2 = now_ns();
  }
  __syncthreads();
  float v[BS * BS / NT];
#pragma unroll
  for (int q = 0; q < BS * BS / NT; ++q) {
    const int e = tid + q * NT;
    const int i = e / BS, c = e % BS;
    if (i < rows && c < rows)
      v[q] = (c <= i) ? __ldcg(L + (size_t)(base + i) * M + base + c) : 0.f;
    else
      v[q] = (i == c) ? 1.f : 0.f;        // identity pad of a ragged tail
  }
#pragma unroll
  for (int q = 0; q < BS * BS / NT; ++q) {
    const int e = tid + q * NT;
    sm.x[e / BS][e % BS] = v[q];
  }
  __syncthreads();
  if (j > 0) {
    const int tx = tid % 16, ty = tid / 16;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (tx * 4 + c <= ty * 4 + ii) sm.x[ty * 4 + ii][tx * 4 + c] -= acc[ii][c];
  }
  factor_tile(sm.x, sm.rd);
#pragma unroll
  for (int q = 0; q < BS * BS / NT; ++q) {
    const int e = tid + q * NT;
    const int i = e / BS, c = e % BS;
    if (i < rows && c < rows) __stcg(L + (size_t)(base + i) * M + base + c, sm.x[i][c]);
    sm.l[i][c] = sm.x[i][c];
  }
  if (tid < BS) sm.rdiag[tid] = 1.f / sm.x[tid][tid];
  if (tid == 0) {
    part[0] += t1 - t0;
    part[1] += t2 - t1;
    part[2] += now_ns() - t2;
  }
}

struct PanelSmem {
  float l[BS][LDT];
  float x[BS][LDS];
  float rdiag[BS];
};

// panel(i, j): P_ij L_jj^T = A_ij in place.
__device__ void panel_task(float* __restrict__ L, int M, int i, int j, PanelSmem& sm) {
  stage_ljj(L, M, j, sm.l, sm.rdiag);
  stage_tile(L, M, i, j, sm.x);
  __syncthreads();
  panel_solve(sm.x, sm.l, sm.rdiag);
  __syncthreads();
  store_tile(L, M, i, j, sm.x);
}

struct UpdateSmem {
  float At[BS][LDT];
  float Bt[BS][LDT];
};

// update(i, k, j): C -= A B^T for [64, 64] tiles, A = P_ij, B = P_kj, C =
// A_ik: A's and C's rows past rows_a and B's rows (C's columns) past
// rows_b read as 0 and are not written.
__device__ void update_task(float* __restrict__ L, int M, int i, int k, int j,
                            UpdateSmem& sm) {
  const int tid = threadIdx.x;
  const int rows_a = min(BS, M - i * BS), rows_b = min(BS, M - k * BS);
  const float* A = L + (size_t)i * BS * M + (size_t)j * BS;
  const float* B = L + (size_t)k * BS * M + (size_t)j * BS;
  float* C = L + (size_t)i * BS * M + (size_t)k * BS;
  const int tx = tid % 16, ty = tid / 16;
  float cv[4][4];                 // C's entries, read before the product
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = ty * 4 + ii, cc = tx * 4 + c;
      cv[ii][c] = (r < rows_a && cc < rows_b) ? __ldcg(C + (size_t)r * M + cc) : 0.f;
    }
#pragma unroll
  for (int q = 0; q < BS * BS / NT; ++q) {
    const int e = tid + q * NT;
    const int r = e / BS, p = e % BS;
    sm.At[p][r] = (r < rows_a) ? __ldcg(A + (size_t)r * M + p) : 0.f;
    sm.Bt[p][r] = (r < rows_b) ? __ldcg(B + (size_t)r * M + p) : 0.f;
  }
  __syncthreads();
  float acc[4][4];
  product_4x4(sm.At, sm.Bt, acc);
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int r = ty * 4 + ii;
    if (r >= rows_a) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int cc = tx * 4 + c;
      if (cc < rows_b) __stcg(C + (size_t)r * M + cc, cv[ii][c] - acc[ii][c]);
    }
  }
}

union Smem {
  DiagSmem diag;
  PanelSmem panel;
  UpdateSmem upd;
};

// work[0]: the pool's next task; work[1 + i * nblk + k]: tile (i, k)'s
// counter.  CTA 0 runs the chain, diag(0) .. diag(nblk - 1); the other CTAs
// take the pool's tasks in order.  trace (optional, else null): nanoseconds
// summed over the CTAs of waiting (taking a task and its inputs' counters)
// and of diag, panel and update work, the three task counts, the first
// start and the last end, then diag's work in its three parts: the panel
// tile's solve (staging, solve, store and publish), the product P P^T, and
// the diagonal tile's factor (its load, the update, the factor, its store).
__global__ void __launch_bounds__(NT, 2)
chol_dag_kernel(float* __restrict__ L, int M, int nblk, int* __restrict__ work,
                long long ntasks, unsigned long long* __restrict__ trace) {
  __shared__ __align__(16) Smem sm;
  __shared__ int s_task;
  // thread 0's sums: waiting, busy by task type, counts by type, diag's parts
  __shared__ unsigned long long s_sum[10];
  int* state = work + 1;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 10) s_sum[tid] = 0;
  const unsigned long long begin = now_ns();
  if (blockIdx.x == 0) {
    // The chain's SM, in the counter of tile (0, 1), which no task uses.
    if (tid == 0 && nblk > 1) st_release(state + 1, sm_id() + 1);
    for (int j = 0; j < nblk; ++j) {
      const unsigned long long t0 = now_ns();
      if (lane == 0 && tid < 64 && j > 0)       // L_{j-1,j-1} is this CTA's own
        wait_ge(state + j * nblk + j - tid / 32, j - 1);
      __syncthreads();
      const unsigned long long t1 = now_ns();
      diag_task(L, M, j, state, nblk, sm.diag, s_sum + 7);
      release(state + j * nblk + j, j + 1);
      if (tid == 0) {
        s_sum[0] += t1 - t0;
        s_sum[1 + kDiag] += now_ns() - t1;
        s_sum[4 + kDiag] += 1;
      }
    }
  } else {
    int g = -1;
    long long g_start = 0, g_end = group_size(-1, nblk);
    if (tid == 0) {                            // leave the chain its SM
      int chain_sm;
      while ((chain_sm = ld_acquire(state + 1)) == 0) __nanosleep(32);
      s_task = (chain_sm == sm_id() + 1);
    }
    __syncthreads();
    if (s_task) return;
    int next = 0;                              // taken one task ahead
    if (tid == 0) next = atomicAdd(work, 1);
    for (;;) {
      const unsigned long long t0 = now_ns();
      if (tid == 0) {
        s_task = next;
        next = atomicAdd(work, 1);
      }
      __syncthreads();
      const long long t = s_task;
      if (t >= ntasks) break;
      while (t >= g_end) {
        ++g;
        g_start = g_end;
        g_end += group_size(g, nblk);
      }
      long long o = t - g_start;
      int type, i, k, j;
      if (g < 0) {                             // panel(o + 2, 0)
        type = kPanel;
        i = (int)o + 2;
        j = k = 0;
      } else {
        const int n = nblk - 2 - g, panels = max(n - 1, 0);
        if (o < n) {                           // update(g + 2 + o, g + 1, g)
          type = kUpdate; i = g + 2 + (int)o; k = g + 1; j = g;
        } else if (o < n + panels) {           // panel(g + 3 + o - n, g + 1)
          type = kPanel; i = g + 3 + (int)(o - n); j = k = g + 1;
        } else {                               // update(i, k, g), k >= g + 2
          o -= n + panels;
          int c = 0;
          while (o >= n - c) { o -= n - c; ++c; }
          type = kUpdate; k = g + 2 + c; i = k + (int)o; j = g;
        }
      }
      if (lane == 0) {                         // one input's counter a warp
        const int w = tid / 32;
        if (type == kPanel) {
          if (w == 0) wait_ge(state + j * nblk + j, j + 1);
          else if (w == 1) wait_ge(state + i * nblk + j, j);
        } else {
          if (w == 0) wait_ge(state + i * nblk + j, j + 1);
          else if (w == 1) wait_ge(state + k * nblk + j, j + 1);
          else if (w == 2) wait_ge(state + i * nblk + k, j);
        }
      }
      __syncthreads();
      const unsigned long long t1 = now_ns();
      if (type == kPanel) panel_task(L, M, i, j, sm.panel);
      else update_task(L, M, i, k, j, sm.upd);
      release(state + i * nblk + k, j + 1);
      if (tid == 0) {
        s_sum[0] += t1 - t0;
        s_sum[1 + type] += now_ns() - t1;
        s_sum[4 + type] += 1;
      }
    }
  }
  if (trace != nullptr && tid == 0) {
    for (int q = 0; q < 7; ++q) atomicAdd(trace + q, s_sum[q]);
    for (int q = 0; q < 3; ++q) atomicAdd(trace + 9 + q, s_sum[7 + q]);
    atomicMin(trace + 7, begin);
    atomicMax(trace + 8, now_ns());
  }
}

}  // namespace

// A [M, M] SPD (lower triangle read), L [M, M] row-major with exact zeros
// above the diagonal, Inv [ceil(M / 64), 64, 64]: all fp32 on the device;
// work: int32 scratch of 1 + ceil(M / 64)^2 entries (any contents); trace:
// null, or 12 uint64 for chol_dag_kernel's timing (7 zeros, UINT64_MAX, 0,
// then 3 zeros).
extern "C" int mgp_cholesky(const void* A, void* L, void* Inv, void* work, void* trace,
                            int M, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  float* l = static_cast<float*>(L);
  int* w = static_cast<int*>(work);
  const int nblk = (M + BS - 1) / BS;
  const size_t total = (size_t)M * M;
  const int grid = (int)((total + NT - 1) / NT < 4096 ? (total + NT - 1) / NT : 4096);
  chol_copy_kernel<<<grid, NT, 0, s>>>(static_cast<const float*>(A), l, M, w,
                                       1 + nblk * nblk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  long long ntasks = 0;
  for (int g = -1; g < nblk - 1; ++g) ntasks += group_size(g, nblk);
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chol_dag_kernel, NT, 0);
  long long pool = (long long)sms * (per_sm > 0 ? per_sm : 1) - 1;
  if (pool < 1) pool = 1;                  // the chain needs the pool's updates
  chol_dag_kernel<<<1 + (int)(ntasks < pool ? ntasks : pool), NT, 0, s>>>(
      l, M, nblk, w, ntasks, static_cast<unsigned long long*>(trace));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return mgp_diag_inv(l, Inv, M, stream);
}
