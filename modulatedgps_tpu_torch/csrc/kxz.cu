// Fused stationary-kernel matrix K[n, m] = var * phi(|x_n / l - z_m / l|^2)
// and its pullback.
//
// Replaces modulatedgps_tpu/ops/pallas_kernels.py:_kxz_pallas
// (_dist_kernel_body + _rbf_epilogue / _matern32_epilogue), and the
// custom_vjp's backward beside it (pallas_kernels.py:155-158, jax.vjp of
// _rbf_xla / _matern32_xla), which XLA fuses under jit.
//
// Bound on the H100: device memory.  The forward stores N*M*4 bytes (134 MB
// for K(Z, X) at M=4096, N=8192, 0.040 ms at 3.35 TB/s); the pullback reads
// K_bar, as many bytes, and recomputes K in registers.  D is small (4 on the
// main path), so the cross term is a few fp32 FMAs an entry; tensor cores and
// TF32 are never used, matching the TPU kernel's HIGHEST cross term.
//
// Forward design: a 64 x 128 output tile per 256-thread block.  The tile's
// X and Z rows are loaded, divided by l and their squared norms formed once,
// into shared memory (Z transposed).  Each thread owns 4 neighbouring
// columns, keeps their scaled Z rows in registers (D <= 8 is a template),
// and walks 8 rows, writing each row segment with one 16-byte store; a warp
// stores 512 contiguous bytes.  A larger D (the generic path) is staged 8
// coordinates at a time, each chunk's cross terms added into the thread's
// 8 x 4 register accumulators, so shared memory does not grow with D.
// (A streaming st.global.cs store was within a few percent on the card; the
// next product reads K at once, so the plain store stays.)
// l is a scalar (stride 0) or [D]; the launcher reads either in place.  The
// arithmetic and its order are the TPU's and the earlier kernel's (bit-equal
// to it): |x|^2 and |z|^2 as squares rounded before each add, the cross term
// as fmaf with d ascending, |x|^2 + |z|^2 - 2 x.z clamped at 0, then the
// epilogue with the signal variance folded in.  Ragged N, M and D are masked.
//
// Pullback design (the closed form of the gradient of the dense formula, with
// torch's clamp_min convention: W = K_bar var phi'(d2) [raw d2 >= 0]):
//   var_bar = sum K_bar phi,  R_a = sum_b W_ab,  C_b = sum_a W_ab,
//   xs_bar_a = 2 (xs_a R_a - sum_b W_ab zs_b),  zs_bar_b likewise,
//   X_bar = xs_bar / l,  l_bar = -(sum_a xs_bar_a xs_a + sum_b zs_bar_b zs_b) / l.
// Pass 1 (kxz_vjp_kernel, 3 blocks an SM): a block takes 128 columns by 256
// rows, reads K_bar once with 16-byte copies (cp.async, one row group ahead of
// the arithmetic), recomputes d2 and the epilogue in registers, and writes
// its partial row sums (R and sum W zs: 1 + D a row) and column sums (C and
// sum W xs: 1 + D a column) and its var_bar partial to a workspace; row sums
// are reduced across a warp's lanes through shared memory, column sums across
// the block's warps.  Pass 2 (kxz_vjp_sum_kernel): a block takes
// 32 rows or columns, its 8 warps a stride-8 share of the tiles each, and
// adds their partials in a fixed order (in double), writes X_bar or X2_bar
// and its share of l_bar; the last block to finish (a counter zeroed before
// the launch) adds the blocks' l_bar and var_bar partials in order.
// No float atomics: the same inputs give the same bits.  Only what the caller
// asks for is computed (needs: 1 X, 2 X2, 4 l, 8 var).  A D over 8 runs pass
// 1 once per 8 coordinates (the sums it accumulates); each of those launches
// forms the full cross term of a row group 8 coordinates at a time, so no
// shared buffer grows with D either.
#include <cuda_runtime.h>

namespace {

constexpr int NTHR = 256;
constexpr int WARPS = NTHR / 32;
constexpr int TILE_M = 128;           // columns of a block: 32 lanes x 4
constexpr int ROWS_W = 8;             // forward: rows a warp writes
constexpr int TILE_N = WARPS * ROWS_W;   // 64 rows of a forward block
constexpr int VJP_RW = 4;             // pullback: rows a warp takes at a time
constexpr int VJP_GROUPS = 8;         // pullback: row groups a warp takes
constexpr int VJP_ROWS = VJP_GROUPS * WARPS * VJP_RW;   // 256 rows of a pullback block
constexpr int GEN_DC = 8;             // D > 8: coordinates a chunk (and a pass-1 launch)
constexpr int SUM_LINES = 32;         // pass 2: rows or columns a block
constexpr int SUM_CH = 5;             // pass 2: components a round (1 + D for D = 4)
constexpr int RED_LD = 33;            // padded stride of the lane-reduction buffer

enum Epilogue { RBF = 0, MATERN32 = 1 };
enum Needs { NEED_X = 1, NEED_Z = 2, NEED_L = 4, NEED_V = 8 };

template <int EPI>
__device__ __forceinline__ float epilogue(float d2, float var) {
  if (EPI == RBF) {
    return var * expf(-0.5f * d2);
  } else {
    const float s3 = 1.7320508075688772f;
    float r = sqrtf(d2 + 1e-36f);
    return var * (1.0f + s3 * r) * expf(-s3 * r);
  }
}

// The pullback's terms of the clamped d2: e, with phi = e (SE) or (1 + s3 r) e
// (Matern-3/2), and phi'(d2) = DPHI e.  __expf: the pullback need not match
// the forward's bits, and its 2-ulp exp sits far inside the gradient's
// tolerance.
template <int EPI>
__device__ __forceinline__ void phi_terms(float d2, float& e, float& phi) {
  if (EPI == RBF) {
    e = __expf(-0.5f * d2);
    phi = e;
  } else {
    const float s3 = 1.7320508075688772f;
    const float r = sqrtf(d2 + 1e-36f);
    e = __expf(-s3 * r);
    phi = (1.0f + s3 * r) * e;
  }
}

template <int EPI>
__host__ __device__ constexpr float dphi_scale() {
  return EPI == RBF ? -0.5f : -1.5f;
}

// Stage coordinates [d0, d0 + DC) of row r0 + i of A [lim, D] divided by l,
// zero past lim and D, row-major (rows[i][DC]) or transposed (rows[k][ld]);
// nrm gathers their squares (each rounded before its add, d ascending).
template <int DC>
__device__ __forceinline__ void stage_chunk(
    const float* __restrict__ A, int lim, int r0, int i,
    const float* __restrict__ ls, int ls_stride, int D, int d0,
    bool transposed, int ld, float* __restrict__ rows, float& nrm) {
  const int g = r0 + i;
  const bool in = g < lim;
  const float* src = A + (size_t)(in ? g : 0) * D;
#pragma unroll
  for (int k = 0; k < DC; ++k) {
    const int d = d0 + k;
    const float v = in && d < D ? src[d] / ls[d * ls_stride] : 0.f;
    if (d < D) nrm = __fadd_rn(nrm, __fmul_rn(v, v));
    if (transposed) rows[k * ld + i] = v; else rows[i * DC + k] = v;
  }
}

// The squared norm of row g of A [lim, D] divided by l, as stage_chunk forms
// it over every chunk; 0 past lim.
__device__ __forceinline__ float row_norm(const float* __restrict__ A, int lim,
                                          int g, const float* __restrict__ ls,
                                          int ls_stride, int D) {
  float nrm = 0.f;
  if (g < lim)
    for (int d = 0; d < D; ++d) {
      const float v = A[(size_t)g * D + d] / ls[d * ls_stride];
      nrm = __fadd_rn(nrm, __fmul_rn(v, v));
    }
  return nrm;
}

// ---------------------------------------------------------------- forward

// Shared: zsT [DC][TILE_M], zn [TILE_M], xs [TILE_N][DC], xn [TILE_N]: the
// tile's rows, all their coordinates (D <= 8) or a chunk of DC (generic),
// and their squared norms.  Thread t < TILE_M + TILE_N stages one row.
template <int EPI, int DC, bool GEN>
__global__ void __launch_bounds__(NTHR)
kxz_kernel(const float* __restrict__ X, const float* __restrict__ Z,
           const float* __restrict__ ls, int ls_stride,
           const float* __restrict__ var_ptr, float* __restrict__ out,
           int N, int M, int D, bool vec) {
  __shared__ __align__(16) float zsT[DC * TILE_M];
  __shared__ __align__(16) float zn[TILE_M];
  __shared__ float xs[TILE_N * DC];
  __shared__ float xn[TILE_N];
  const int Dn = GEN ? D : DC;
  const int n0 = blockIdx.y * TILE_N;
  const int m0 = blockIdx.x * TILE_M;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int mc = 4 * lane;
  const int m = m0 + mc;

  float nrm = 0.f;                          // the norm of the row t stages
  float cg[GEN ? ROWS_W : 1][4] = {};       // generic: the warp's rows' cross terms
  for (int d0 = 0; d0 < Dn; d0 += DC) {
    if (d0 > 0) __syncthreads();            // the last chunk read
    if (t < TILE_M)
      stage_chunk<DC>(Z, M, m0, t, ls, ls_stride, Dn, d0, true, TILE_M, zsT, nrm);
    else if (t < TILE_M + TILE_N)
      stage_chunk<DC>(X, N, n0, t - TILE_M, ls, ls_stride, Dn, d0, false, 0,
                      xs, nrm);
    __syncthreads();
    if constexpr (GEN) {
#pragma unroll
      for (int j = 0; j < ROWS_W; ++j) {
        const int r = warp * ROWS_W + j;
#pragma unroll
        for (int k = 0; k < DC; ++k) {
          if (d0 + k >= D) break;
          const float xv = xs[r * DC + k];
          const float4 z = *reinterpret_cast<const float4*>(zsT + k * TILE_M + mc);
          cg[j][0] = fmaf(xv, z.x, cg[j][0]);
          cg[j][1] = fmaf(xv, z.y, cg[j][1]);
          cg[j][2] = fmaf(xv, z.z, cg[j][2]);
          cg[j][3] = fmaf(xv, z.w, cg[j][3]);
        }
      }
    }
  }
  if (t < TILE_M) zn[t] = nrm;
  else if (t < TILE_M + TILE_N) xn[t - TILE_M] = nrm;
  __syncthreads();

  const float4 zn4 = *reinterpret_cast<const float4*>(zn + mc);
  const float znr[4] = {zn4.x, zn4.y, zn4.z, zn4.w};
  const float var = *var_ptr;
  auto store_row = [&](int r, const float* c) {
    const float xnr = xn[r];
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = epilogue<EPI>(fmaxf(xnr + znr[e] - 2.0f * c[e], 0.0f), var);
    float* dst = out + (size_t)(n0 + r) * M + m;
    if (vec && m + 3 < M) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (m + e < M) dst[e] = o[e];
    }
  };

  if constexpr (GEN) {
#pragma unroll
    for (int j = 0; j < ROWS_W; ++j)
      if (n0 + warp * ROWS_W + j < N) store_row(warp * ROWS_W + j, cg[j]);
  } else {
    float zr[4][DC];
#pragma unroll
    for (int d = 0; d < DC; ++d) {
      const float4 z = *reinterpret_cast<const float4*>(zsT + d * TILE_M + mc);
      zr[0][d] = z.x; zr[1][d] = z.y; zr[2][d] = z.z; zr[3][d] = z.w;
    }
#pragma unroll 2
    for (int j = 0; j < ROWS_W; ++j) {
      const int r = warp * ROWS_W + j;
      if (n0 + r >= N) break;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int d = 0; d < DC; ++d) {
        const float xv = xs[r * DC + d];
#pragma unroll
        for (int e = 0; e < 4; ++e) c[e] = fmaf(xv, zr[e][d], c[e]);
      }
      store_row(r, c);
    }
  }
}

// --------------------------------------------------------------- pullback

// 16-byte asynchronous copy global -> shared; bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared: kbuf [WARPS][2][VJP_RW][32] float4 (each warp's two K_bar stages),
// zsT [DC][TILE_M], zn [TILE_M], xs [VJP_ROWS][DC], xn [VJP_ROWS] (the
// launch's DC coordinates of the block's rows and their full norms); on the
// generic path czT [DC][TILE_M] and cx [WARPS * VJP_RW][DC], a row group's
// chunk for its cross terms; then the reduction buffer: per warp
// [(1 + DC) * VJP_RW][RED_LD] (row sums), or at the end
// [WARPS][(1 + DC) * TILE_M] (column sums), and var[WARPS].
constexpr int VJP_KBUF_FLOATS = WARPS * 2 * VJP_RW * 32 * 4;
constexpr int GROUP_ROWS = WARPS * VJP_RW;   // 32 rows of a row group

template <int DC>
__host__ __device__ constexpr int vjp_red_floats() {
  return WARPS * (1 + DC) * VJP_RW * RED_LD > WARPS * (1 + DC) * TILE_M
             ? WARPS * (1 + DC) * VJP_RW * RED_LD
             : WARPS * (1 + DC) * TILE_M;
}

// rowpart [nct][1 + D][N], colpart [nrg][1 + D][M], blockpart (double):
// var partials [nrg][nct].  Coordinates d0 .. d0 + DC - 1 (those below D);
// the W sums (component 0) and var partials only when d0 == 0.  The block's
// 128 Z rows and 256 X rows are staged once; then each warp walks its 8
// groups of 4 rows (group g: rows 32 g + 4 warp ..) with no block barrier
// until the column sums, except on the generic path, where the block stages
// each group's 32 rows and its 128 columns a chunk at a time to form their
// cross terms.  With 16-byte rows (vec), a group's K_bar segments come by
// cp.async into the warp's other stage while it computes the last.
template <int EPI, int DC, bool GEN>
__global__ void __launch_bounds__(NTHR, 3)
kxz_vjp_kernel(const float* __restrict__ X, const float* __restrict__ Z,
               const float* __restrict__ ls, int ls_stride,
               const float* __restrict__ var_ptr, const float* __restrict__ Kbar,
               float* __restrict__ rowpart, float* __restrict__ colpart,
               double* __restrict__ varpart, int N, int M, int D, int d0,
               int needs, bool vec) {
  extern __shared__ float4 sh4[];
  float* sh = reinterpret_cast<float*>(sh4);
  const int Dn = GEN ? D : DC;
  float4* kbuf = sh4;                       // [WARPS][2][VJP_RW][32]
  float* zsT = sh + VJP_KBUF_FLOATS;        // [DC][TILE_M]
  float* zn = zsT + DC * TILE_M;            // [TILE_M]
  float* xs = zn + TILE_M;                  // [VJP_ROWS][DC]
  float* xn = xs + VJP_ROWS * DC;           // [VJP_ROWS]
  float* czT = xn + VJP_ROWS;               // generic: [DC][TILE_M]
  float* cx = czT + (GEN ? DC * TILE_M : 0);   // generic: [GROUP_ROWS][DC]
  float* red = cx + (GEN ? GROUP_ROWS * DC : 0);   // vjp_red_floats<DC>()
  float* vred = red + vjp_red_floats<DC>(); // [WARPS]

  const bool rows_on = needs & (NEED_X | NEED_L);
  const bool cols_on = needs & (NEED_Z | NEED_L);
  const bool var_on = (needs & NEED_V) && d0 == 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mc = 4 * lane;
  const int m0 = blockIdx.x * TILE_M;
  const int m = m0 + mc;
  const int rb0 = blockIdx.y * VJP_ROWS;
  const int ncomp = 1 + D;                  // components of a partial line
  float* red_w = red + warp * (1 + DC) * VJP_RW * RED_LD;
  float4* kq = kbuf + warp * 2 * VJP_RW * 32;

  // Group g's K_bar segments of this lane into stage g & 1 (zeros past N, M).
  auto fetch = [&](int g) {
    const int n0 = rb0 + g * GROUP_ROWS + warp * VJP_RW;
#pragma unroll
    for (int j = 0; j < VJP_RW; ++j) {
      const bool in = n0 + j < N && m < M;
      cp_async16(kq + ((g & 1) * VJP_RW + j) * 32 + lane,
                 in ? Kbar + (size_t)(n0 + j) * M + m : Kbar, in ? 16 : 0);
    }
    cp_async_commit();
  };
  if (vec) fetch(0);

  for (int r = threadIdx.x; r < TILE_M + VJP_ROWS; r += NTHR) {
    float nrm = 0.f;
    if (r < TILE_M) {
      stage_chunk<DC>(Z, M, m0, r, ls, ls_stride, Dn, d0, true, TILE_M, zsT, nrm);
      if (GEN) nrm = row_norm(Z, M, m0 + r, ls, ls_stride, D);
      zn[r] = nrm;
    } else {
      stage_chunk<DC>(X, N, rb0, r - TILE_M, ls, ls_stride, Dn, d0, false, 0,
                      xs, nrm);
      if (GEN) nrm = row_norm(X, N, rb0 + r - TILE_M, ls, ls_stride, D);
      xn[r - TILE_M] = nrm;
    }
  }
  __syncthreads();

  // The launch's coordinates of this thread's 4 columns, and their norms.
  float zr[4][DC];
#pragma unroll
  for (int k = 0; k < DC; ++k) {
    const float4 t = *reinterpret_cast<const float4*>(zsT + k * TILE_M + mc);
    zr[0][k] = t.x; zr[1][k] = t.y; zr[2][k] = t.z; zr[3][k] = t.w;
  }
  const float4 zn4 = *reinterpret_cast<const float4*>(zn + mc);
  const float znr[4] = {zn4.x, zn4.y, zn4.z, zn4.w};
  const float wscale = *var_ptr * dphi_scale<EPI>();   // W = Kbar e wscale

  float ccol[4][1 + DC];                    // column sums over this thread's rows
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int k = 0; k <= DC; ++k) ccol[e][k] = 0.f;
  float vsum = 0.f;

  for (int g = 0; g < VJP_GROUPS; ++g) {
    const int rl0 = g * GROUP_ROWS + warp * VJP_RW;   // first row, local
    const int n0 = rb0 + rl0;
    // The generic path's barriers need every warp: its break is the block's.
    if (GEN ? rb0 + g * GROUP_ROWS >= N : n0 >= N) break;
    float4 kb[VJP_RW];
    if (vec) {
      if (g + 1 < VJP_GROUPS) fetch(g + 1); else cp_async_commit();
      cp_async_wait<1>();                   // group g's copies (this lane's own)
#pragma unroll
      for (int j = 0; j < VJP_RW; ++j) kb[j] = kq[((g & 1) * VJP_RW + j) * 32 + lane];
    } else {
#pragma unroll
      for (int j = 0; j < VJP_RW; ++j) {
        const float* src = Kbar + (size_t)(n0 + j) * M + m;
        const bool in = n0 + j < N;
        kb[j].x = in && m < M ? src[0] : 0.f;
        kb[j].y = in && m + 1 < M ? src[1] : 0.f;
        kb[j].z = in && m + 2 < M ? src[2] : 0.f;
        kb[j].w = in && m + 3 < M ? src[3] : 0.f;
      }
    }
    float cg[GEN ? VJP_RW : 1][4] = {};     // generic: the cross terms over all D
    if constexpr (GEN) {
      for (int c0 = 0; c0 < D; c0 += DC) {
        __syncthreads();                    // the last chunk read
        const int t = threadIdx.x;
        float unused = 0.f;
        if (t < TILE_M)
          stage_chunk<DC>(Z, M, m0, t, ls, ls_stride, D, c0, true, TILE_M, czT,
                          unused);
        else if (t < TILE_M + GROUP_ROWS)
          stage_chunk<DC>(X, N, rb0 + g * GROUP_ROWS, t - TILE_M, ls, ls_stride,
                          D, c0, false, 0, cx, unused);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < VJP_RW; ++j) {
#pragma unroll
          for (int k = 0; k < DC; ++k) {
            if (c0 + k >= D) break;
            const float xv = cx[(warp * VJP_RW + j) * DC + k];
            const float4 z = *reinterpret_cast<const float4*>(czT + k * TILE_M + mc);
            cg[j][0] = fmaf(xv, z.x, cg[j][0]);
            cg[j][1] = fmaf(xv, z.y, cg[j][1]);
            cg[j][2] = fmaf(xv, z.z, cg[j][2]);
            cg[j][3] = fmaf(xv, z.w, cg[j][3]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < VJP_RW; ++j) {
      const int r = rl0 + j;
      float xk[DC];
#pragma unroll
      for (int k = 0; k < DC; ++k) xk[k] = xs[r * DC + k];
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (GEN) {
#pragma unroll
        for (int e = 0; e < 4; ++e) c[e] = cg[j][e];
      } else {
#pragma unroll
        for (int d = 0; d < DC; ++d)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[e] = fmaf(xk[d], zr[e][d], c[e]);
      }
      const float xnr = xn[r];
      const float kbe[4] = {kb[j].x, kb[j].y, kb[j].z, kb[j].w};
      float racc[1 + DC];
#pragma unroll
      for (int k = 0; k <= DC; ++k) racc[k] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float raw = xnr + znr[e] - 2.0f * c[e];
        float ex, phi;
        phi_terms<EPI>(fmaxf(raw, 0.0f), ex, phi);
        vsum = fmaf(kbe[e], phi, vsum);
        const float w = raw >= 0.0f ? kbe[e] * ex * wscale : 0.0f;
        racc[0] += w;
        ccol[e][0] += w;
#pragma unroll
        for (int k = 0; k < DC; ++k) {
          racc[1 + k] = fmaf(w, zr[e][k], racc[1 + k]);
          ccol[e][1 + k] = fmaf(w, xk[k], ccol[e][1 + k]);
        }
      }
      if (rows_on) {
#pragma unroll
        for (int k = 0; k <= DC; ++k) red_w[(k * VJP_RW + j) * RED_LD + lane] = racc[k];
      }
    }
    if (rows_on) {
      // Each (component, row) pair: its 32 lanes added in lane order.
      __syncwarp();
      for (int p = lane; p < (1 + DC) * VJP_RW; p += 32) {
        const int k = p / VJP_RW, j = p % VJP_RW;
        const float* src = red_w + p * RED_LD;
        float s = 0.f;
#pragma unroll 8
        for (int l = 0; l < 32; ++l) s += src[l];
        const int n = n0 + j;
        const int comp = k == 0 ? 0 : 1 + d0 + k - 1;
        if (n < N && (k == 0 ? d0 == 0 : d0 + k - 1 < D))
          rowpart[((size_t)blockIdx.x * ncomp + comp) * N + n] = s;
      }
      __syncwarp();
    }
  }

  if (vec) cp_async_wait<0>();              // no copy in flight past the loop
  __syncthreads();                          // every warp's row buffers read
  if (cols_on) {
    // Column sums: each (component, column) pair over the warps in order.
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int k = 0; k <= DC; ++k)
        red[(warp * (1 + DC) + k) * TILE_M + mc + e] = ccol[e][k];
    __syncthreads();
    for (int q = threadIdx.x; q < (1 + DC) * TILE_M; q += NTHR) {
      const int k = q / TILE_M, col = q % TILE_M;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[(w * (1 + DC) + k) * TILE_M + col];
      const int comp = k == 0 ? 0 : 1 + d0 + k - 1;
      if (m0 + col < M && (k == 0 ? d0 == 0 : d0 + k - 1 < D))
        colpart[((size_t)blockIdx.y * ncomp + comp) * M + m0 + col] = s;
    }
  }
  if (var_on) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) vsum += __shfl_xor_sync(0xffffffffu, vsum, o);
    if (lane == 0) vred[warp] = vsum;
    __syncthreads();
    if (threadIdx.x == 0) {
      double s = 0.0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += vred[w];
      varpart[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
    }
  }
}

// Sum over the block in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ double block_sum_d(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();                          // red[] free from an earlier sum
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

// Pass 2.  A block takes SUM_LINES lines: line i < N is row i (X's side),
// else column i - N (X2's side).  Warp w adds the tiles w, w + 8, ... of its
// lane's line, SUM_CH components at a time (their loads in flight together),
// then warp 0 adds the 8 warps' sums in order and forms the line's gradient
// and its share of l_bar.  blockpart: [nrg * nct] var partials,
// [gridDim.x * D] l_bar partials, and the counter in the slot after them.
__global__ void __launch_bounds__(NTHR)
kxz_vjp_sum_kernel(const float* __restrict__ X, const float* __restrict__ Z,
                   const float* __restrict__ ls, int ls_stride,
                   const float* __restrict__ rowpart,
                   const float* __restrict__ colpart, double* blockpart,
                   float* __restrict__ Xbar, float* __restrict__ Zbar,
                   float* __restrict__ lbar, float* __restrict__ vbar, int N,
                   int M, int D, int nct, int nrg, int needs) {
  __shared__ double wsum[WARPS][SUM_CH][32];
  __shared__ double red[WARPS];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * SUM_LINES + lane;
  const bool is_row = i < N;
  const bool on = i < N + M &&
                  ((needs & NEED_L) || (needs & (is_row ? NEED_X : NEED_Z)));
  const int line = is_row ? i : i - N;
  const int lim = is_row ? N : M;
  const int ntiles = is_row ? nct : nrg;
  const float* part = is_row ? rowpart : colpart;
  const float* A = is_row ? X : Z;
  float* bar = (needs & (is_row ? NEED_X : NEED_Z)) ? (is_row ? Xbar : Zbar)
                                                      : nullptr;
  const size_t stride = (size_t)(1 + D) * lim;
  double* varpart = blockpart;
  double* lpart = blockpart + (size_t)nrg * nct;
  unsigned int* counter =
      reinterpret_cast<unsigned int*>(lpart + (size_t)gridDim.x * D);

  double R = 0.0;
  for (int c0 = 0; c0 <= D; c0 += SUM_CH) {
    double s[SUM_CH];
#pragma unroll
    for (int k = 0; k < SUM_CH; ++k) s[k] = 0.0;
    if (on) {
      const float* src = part + (size_t)c0 * lim + line;
#pragma unroll 2
      for (int t = warp; t < ntiles; t += WARPS) {
        float v[SUM_CH];
#pragma unroll
        for (int k = 0; k < SUM_CH; ++k)
          v[k] = c0 + k <= D ? src[t * stride + (size_t)k * lim] : 0.f;
#pragma unroll
        for (int k = 0; k < SUM_CH; ++k) s[k] += v[k];
      }
    }
#pragma unroll
    for (int k = 0; k < SUM_CH; ++k) wsum[warp][k][lane] = s[k];
    __syncthreads();
    if (warp == 0) {
      for (int k = 0; k < SUM_CH && c0 + k <= D; ++k) {
        double tot = 0.0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) tot += wsum[w][k][lane];
        const int c = c0 + k;
        if (c == 0) {
          R = tot;
          continue;
        }
        const int d = c - 1;
        double term = 0.0;
        if (on) {
          const float l = ls[d * ls_stride];
          const float xs = A[(size_t)line * D + d] / l;
          const double g = 2.0 * ((double)xs * R - tot);
          if (bar) bar[(size_t)line * D + d] = (float)(g / l);
          term = g * xs;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) term += __shfl_xor_sync(0xffffffffu, term, o);
        if (lane == 0) lpart[(size_t)blockIdx.x * D + d] = term;
      }
    }
    __syncthreads();                        // wsum[] read
  }

  // The last block adds every block's partials in order.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const volatile double* vl = lpart;
  const volatile double* vv = varpart;
  double lsum = 0.0;                        // scalar l: the sum over d
  for (int d = 0; d < D; ++d) {
    double s = 0.0;
    for (int b = threadIdx.x; b < (int)gridDim.x; b += NTHR) s += vl[(size_t)b * D + d];
    s = block_sum_d(s, red);
    if (threadIdx.x == 0) {
      const double lb = -s / ls[d * ls_stride];
      lsum += lb;
      if ((needs & NEED_L) && ls_stride) lbar[d] = (float)lb;
    }
  }
  if (threadIdx.x == 0 && (needs & NEED_L) && !ls_stride) lbar[0] = (float)lsum;
  double v = 0.0;
  for (int b = threadIdx.x; b < nrg * nct; b += NTHR) v += vv[b];
  v = block_sum_d(v, red);
  if (threadIdx.x == 0 && (needs & NEED_V)) vbar[0] = (float)v;
}

// ---------------------------------------------------------------- launchers

template <int DC, bool GEN>
constexpr size_t vjp_smem() {
  return sizeof(float) * (VJP_KBUF_FLOATS + (DC + 1) * (TILE_M + VJP_ROWS) +
                          (GEN ? DC * (TILE_M + GROUP_ROWS) : 0) +
                          vjp_red_floats<DC>() + WARPS);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Args {
  const float *X, *Z, *ls, *var, *Kbar;
  float *out, *rowpart, *colpart;
  double* blockpart;
  int ls_stride, N, M, D, needs;
  bool vec;
  cudaStream_t s;
};

template <int EPI, int DC, bool GEN>
cudaError_t launch_fwd(const Args& a) {
  dim3 grid((a.M + TILE_M - 1) / TILE_M, (a.N + TILE_N - 1) / TILE_N);
  kxz_kernel<EPI, DC, GEN><<<grid, NTHR, 0, a.s>>>(
      a.X, a.Z, a.ls, a.ls_stride, a.var, a.out, a.N, a.M, a.D, a.vec);
  return cudaGetLastError();
}

template <int EPI, int DC, bool GEN>
cudaError_t launch_vjp(const Args& a, int d0) {
  auto kernel = kxz_vjp_kernel<EPI, DC, GEN>;
  constexpr size_t smem = vjp_smem<DC, GEN>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.M + TILE_M - 1) / TILE_M, (a.N + VJP_ROWS - 1) / VJP_ROWS);
  kernel<<<grid, NTHR, smem, a.s>>>(a.X, a.Z, a.ls, a.ls_stride, a.var, a.Kbar,
                                    a.rowpart, a.colpart, a.blockpart, a.N,
                                    a.M, a.D, d0, a.needs, a.vec);
  return cudaGetLastError();
}

// The forward (vjp false) or pass 1 of the pullback for kind EPI, D <= 8 as
// a template, a larger D on the generic path.
template <int EPI>
cudaError_t dispatch(const Args& a, bool vjp) {
  if (vjp && a.D > GEN_DC) {
    for (int d0 = 0; d0 < a.D; d0 += GEN_DC) {
      cudaError_t err = launch_vjp<EPI, GEN_DC, true>(a, d0);
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  }
#define MGP_KXZ_CASE(DC) \
  case DC: return vjp ? launch_vjp<EPI, DC, false>(a, 0) : launch_fwd<EPI, DC, false>(a);
  switch (a.D) {
    MGP_KXZ_CASE(1) MGP_KXZ_CASE(2) MGP_KXZ_CASE(3) MGP_KXZ_CASE(4)
    MGP_KXZ_CASE(5) MGP_KXZ_CASE(6) MGP_KXZ_CASE(7) MGP_KXZ_CASE(8)
    default: return launch_fwd<EPI, GEN_DC, true>(a);
  }
#undef MGP_KXZ_CASE
}

bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

}  // namespace

// X [N, D], Z [M, D], ls [D] (ls_stride 1) or a scalar (ls_stride 0), var [1]
// (all fp32, device) -> out [N, M].  kind 0 = squared exponential, 1 =
// Matern-3/2.
extern "C" int mgp_kxz(const void* X, const void* Z, const void* ls,
                       const void* var, void* out, int N, int M, int D,
                       int ls_stride, int kind, void* stream) {
  if (N <= 0 || M <= 0) return static_cast<int>(cudaGetLastError());
  Args a{};
  a.X = static_cast<const float*>(X);
  a.Z = static_cast<const float*>(Z);
  a.ls = static_cast<const float*>(ls);
  a.var = static_cast<const float*>(var);
  a.out = static_cast<float*>(out);
  a.ls_stride = ls_stride;
  a.N = N; a.M = M; a.D = D;
  a.vec = M % 4 == 0 && aligned16(out);
  a.s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(kind == MATERN32 ? dispatch<MATERN32>(a, false)
                                           : dispatch<RBF>(a, false));
}

// The pullback of mgp_kxz for the cotangent Kbar [N, M] (fp32, device).
// needs: 1 Xbar [N, D], 2 Zbar [M, D], 4 lbar (ls's shape: [D] or [1]),
// 8 vbar [1]; the outputs not asked for may be null.  Workspace:
// rowpart [ceil(M / 128)][1 + D][N] f32 (asked for X or l), colpart
// [ceil(N / 256)][1 + D][M] f32 (asked for X2 or l), blockpart f64 of
// ceil(N / 256) * ceil(M / 128) + max(1, ceil((N + M) / 32)) * D + 1.
extern "C" int mgp_kxz_vjp(const void* X, const void* Z, const void* ls,
                           const void* var, const void* Kbar, void* rowpart,
                           void* colpart, void* blockpart, void* Xbar,
                           void* Zbar, void* lbar, void* vbar, int N, int M,
                           int D, int ls_stride, int kind, int needs,
                           void* stream) {
  if (N < 0 || M < 0 || D <= 0 || needs == 0)
    return static_cast<int>(cudaGetLastError());
  Args a{};
  a.X = static_cast<const float*>(X);
  a.Z = static_cast<const float*>(Z);
  a.ls = static_cast<const float*>(ls);
  a.var = static_cast<const float*>(var);
  a.Kbar = static_cast<const float*>(Kbar);
  a.rowpart = static_cast<float*>(rowpart);
  a.colpart = static_cast<float*>(colpart);
  a.blockpart = static_cast<double*>(blockpart);
  a.ls_stride = ls_stride;
  a.N = N; a.M = M; a.D = D;
  a.needs = needs;
  a.vec = M % 4 == 0 && aligned16(Kbar);   // 16-byte K_bar rows: cp.async
  a.s = static_cast<cudaStream_t>(stream);
  const int nct = (M + TILE_M - 1) / TILE_M;
  const int nrg = (N + VJP_ROWS - 1) / VJP_ROWS;
  const int nsum = N + M > 0 ? (N + M + SUM_LINES - 1) / SUM_LINES : 1;
  double* counter = a.blockpart + (size_t)nrg * nct + (size_t)nsum * D;
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(unsigned int), a.s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N > 0 && M > 0) {
    err = kind == MATERN32 ? dispatch<MATERN32>(a, true) : dispatch<RBF>(a, true);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kxz_vjp_sum_kernel<<<nsum, NTHR, 0, a.s>>>(
      a.X, a.Z, a.ls, ls_stride, a.rowpart, a.colpart, a.blockpart,
      static_cast<float*>(Xbar), static_cast<float*>(Zbar),
      static_cast<float*>(lbar), static_cast<float*>(vbar), N, M, D, nct, nrg,
      needs);
  return static_cast<int>(cudaGetLastError());
}
