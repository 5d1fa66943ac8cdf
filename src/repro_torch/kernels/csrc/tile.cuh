// The f32 distance tile shared by the pairwise kernel (distance.cu) and the
// fused NLJ count kernel (nlj.cu).
//
// One 256-thread block computes the dot products of a 128x128 tile of
// (query row, data row) pairs: d walked in slices of 8 staged k-major in
// shared memory, an 8x8 register tile per thread, each dot accumulated as
// one fmaf chain over dimensions 0..d-1 from 0. Both kernels take their
// dots from tile_dots and finish each one with dist_epilogue, so a
// distance the NLJ count compares with θ² is bit for bit the value the
// pairwise kernel writes for the same pair, given the same norm tensors.

#pragma once

#include <cuda_runtime.h>

namespace repro_tile {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 8;
constexpr int kThreads = 256;

// Four consecutive floats of row r, columns [c, c+4), zero outside the
// (nrows, d) matrix. vec4: d % 4 == 0 and a 16-byte aligned base pointer.
__device__ __forceinline__ void load_row4(const float* __restrict__ p, long long r,
                                          long long nrows, int c, int d, int vec4,
                                          float v[4]) {
  if (r < nrows) {
    const float* rowp = p + r * (long long)d;
    if (vec4 && c < d) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(rowp + c));
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
      return;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = (c + i < d) ? __ldg(rowp + c + i) : 0.f;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = 0.f;
}

// The matmul-form distance epilogue. 2.f * dot is exact, so whether nvcc
// contracts the subtraction into an fma does not change the rounded result.
__device__ __forceinline__ float dist_epilogue(float xn, float yn, float dot) {
  return fmaxf(xn + yn - 2.f * dot, 0.f);
}

// Tile row of register row i of thread row ty, tile column of register
// column j of thread column tx (two 4-wide halves, 64 apart: the float4
// shared-memory reads stay conflict-free).
__device__ __forceinline__ int tile_row(int ty, int i) {
  return i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4);
}
__device__ __forceinline__ int tile_col(int tx, int j) {
  return j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4);
}

// acc[i][j] = <x[row0 + tile_row(ty, i)], y[col0 + tile_col(tx, j)]> for
// thread (tx, ty) = (tid % 16, tid / 16); rows and columns outside the
// matrices read zeros. Every thread of the block must call it.
__device__ __forceinline__ void tile_dots(const float* __restrict__ x,
                                          const float* __restrict__ y,
                                          int B, int N, int d, int vec4,
                                          long long row0, long long col0,
                                          float (&As)[kBK][kBM],
                                          float (&Bs)[kBK][kBN],
                                          float (&acc)[8][8]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  // loader: the 128x8 slice of each operand is 1024 floats, 4 per thread
  const int lr = tid / 2;
  const int lc = (tid % 2) * 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
    float v[4];
    load_row4(x, row0 + lr, B, k0 + lc, d, vec4, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) As[lc + i][lr] = v[i];
    load_row4(y, col0 + lr, N, k0 + lc, d, vec4, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) Bs[lc + i][lr] = v[i];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace repro_tile
