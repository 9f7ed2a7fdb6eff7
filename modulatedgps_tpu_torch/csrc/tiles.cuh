// Tile helpers of the kernels that stage through registers (trimm.cu):
// 16-byte staging loads with ragged-edge masking, and the fp32 epilogue
// that writes a warp's wmma accumulator fragments to a row-major matrix;
// Pack8 serves hopper.cuh.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace mgp {

// Eight bf16 values as raw bits (bf16 zero is all-zero bits).
union Pack8 {
  uint4 u;
  unsigned short s[8];
};

// Four fp32 of row `row`, columns col..col+3, of a row-major [n, n] matrix;
// entries past the edge read as 0.  vec_ok: n % 4 == 0.
__device__ __forceinline__ float4 load_row4(const float* __restrict__ base,
                                            int row, int col, int n, bool vec_ok) {
  if (row < n && vec_ok && col + 4 <= n)
    return *reinterpret_cast<const float4*>(base + (size_t)row * n + col);
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = (row < n && col + e < n) ? base[(size_t)row * n + col + e] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

using Acc = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

// Writes a warp's FR x FC accumulator fragments, whose top-left element is
// (r0, c0), into out[rows, cols] (row pitch ld), through the warp's 16x16
// staging buffer `st`.  With lower_only, entries above the diagonal
// (row < col) are written as 0.
template <int FR, int FC>
__device__ __forceinline__ void store_acc(Acc (&acc)[FR][FC], float* st,
                                          float* __restrict__ out, size_t ld,
                                          int rows, int cols, int r0, int c0,
                                          bool lower_only, int lane) {
  const int r = lane / 2, c8 = (lane % 2) * 8;
  const bool vec_ok = (ld % 4) == 0;
#pragma unroll
  for (int i = 0; i < FR; ++i) {
#pragma unroll
    for (int j = 0; j < FC; ++j) {
      nvcuda::wmma::store_matrix_sync(st, acc[i][j], 16, nvcuda::wmma::mem_row_major);
      __syncwarp();
      const int row = r0 + i * 16 + r;
      const int col = c0 + j * 16 + c8;
      if (row < rows) {
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          v[q] = (lower_only && row < col + q) ? 0.f : st[r * 16 + c8 + q];
        float* dst = out + (size_t)row * ld + col;
        if (vec_ok && col + 8 <= cols) {
          reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
          reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (col + q < cols) dst[q] = v[q];
        }
      }
      __syncwarp();
    }
  }
}

// Zeroes the [bt, bt] tile at (r0, c0) of out[rows, cols] with the whole block.
__device__ __forceinline__ void zero_tile(float* __restrict__ out, size_t ld,
                                          int rows, int cols, int r0, int c0,
                                          int bt) {
  for (int e = threadIdx.x; e < bt * bt; e += blockDim.x) {
    const int row = r0 + e / bt, col = c0 + e % bt;
    if (row < rows && col < cols) out[(size_t)row * ld + col] = 0.f;
  }
}

}  // namespace mgp
