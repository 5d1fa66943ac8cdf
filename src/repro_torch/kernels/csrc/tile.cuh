// The f32 distance tile shared by the pairwise kernel (distance.cu) and the
// fused NLJ count kernel (nlj.cu).
//
// One 256-thread block computes the dot products of a 128x128 tile of
// (query row, data row) pairs with an 8x8 register tile per thread, each
// dot accumulated as one fmaf chain over dimensions 0..d-1 from 0 (no
// split-K, no TF32), so every dot is the same value whatever the tile
// shape. Both kernels take their dots from tile_dots and finish each one
// with dist_epilogue, so a distance the NLJ count compares with θ² is bit
// for bit the value the pairwise kernel writes for the same pair, given
// the same norm tensors.
//
// Bound: 2·d FMA-pairs per output on the CUDA cores (the H100's f32 rate,
// 67 TFLOP/s), against 4 output bytes: at d = 128 the tile is bound by the
// FMAs. The design keeps them fed: d is walked in slices of kBK staged
// k-major in two shared buffers. While the block computes slice s from one
// buffer, each thread already holds slice s+1 in registers (loaded with
// 16-byte __ldg at the top of the step) and stores it into the other
// buffer after its FMAs, so the global loads' latency hides behind
// kBK·64 FMAs per thread and each slice costs one barrier, not two. At 127
// registers a thread (no spills) two blocks share an SM. (Blocks that walk
// a strip of column tiles, with the pipeline running on from one tile into
// the next, timed 5% slower on an H100: the walk's state spilled.)

#pragma once

#include <cuda_runtime.h>

namespace repro_tile {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 8;               // dims per staged slice (16: slower)
constexpr int kThreads = 256;
// the loader: a slice of one operand is 128 rows x kBK floats, read as
// float4s; kLoads of them per thread
constexpr int kQuads = kBK / 4;                    // float4s per row slice
constexpr int kLoads = kBM * kQuads / kThreads;    // float4s per thread

// Four consecutive floats of row r, columns [c, c+4), zero outside the
// (nrows, d) matrix. vec4: d % 4 == 0 and a 16-byte aligned base pointer.
__device__ __forceinline__ float4 load_row4(const float* __restrict__ p,
                                            long long r, long long nrows,
                                            int c, int d, int vec4) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r < nrows) {
    const float* rowp = p + r * (long long)d;
    if (vec4) {
      if (c < d) v = __ldg(reinterpret_cast<const float4*>(rowp + c));
    } else {
      if (c < d) v.x = __ldg(rowp + c);
      if (c + 1 < d) v.y = __ldg(rowp + c + 1);
      if (c + 2 < d) v.z = __ldg(rowp + c + 2);
      if (c + 3 < d) v.w = __ldg(rowp + c + 3);
    }
  }
  return v;
}

// The matmul-form distance epilogue. 2.f * dot is exact, so whether nvcc
// contracts the subtraction into an fma does not change the rounded result.
__device__ __forceinline__ float dist_epilogue(float xn, float yn, float dot) {
  return fmaxf(xn + yn - 2.f * dot, 0.f);
}

// Tile row of register row i of thread row ty, tile column of register
// column j of thread column tx (two 4-wide halves, 64 apart: the float4
// shared-memory reads stay conflict-free, and columns 4tx..4tx+3 and
// 64+4tx..64+4tx+3 leave the thread as two 16-byte stores).
__device__ __forceinline__ int tile_row(int ty, int i) {
  return i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4);
}
__device__ __forceinline__ int tile_col(int tx, int j) {
  return j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4);
}

struct Smem {
  float a[2][kBK][kBM];
  float b[2][kBK][kBN];
};

// acc[i][j] = <x[row0 + tile_row(ty, i)], y[col0 + tile_col(tx, j)]> for
// thread (tx, ty) = (tid % 16, tid / 16): the 16 threads of one tile row
// are one half-warp. Rows and columns outside the matrices read zeros.
// Every thread of the block must call it.
__device__ __forceinline__ void tile_dots(const float* __restrict__ x,
                                          const float* __restrict__ y,
                                          int B, int N, int d, int vec4,
                                          long long row0, long long col0,
                                          Smem& sm, float (&acc)[8][8]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // loader: float4 l of this thread is row (tid + l·256) / kQuads, columns
  // 4·((tid + l·256) % kQuads) .. +3 of the slice; neighbouring threads
  // read neighbouring 16-byte pieces of one row
  float4 va[kLoads], vb[kLoads];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int u = tid + l * kThreads;
      const int r = u / kQuads;
      const int c = k0 + (u % kQuads) * 4;
      va[l] = load_row4(x, row0 + r, B, c, d, vec4);
      vb[l] = load_row4(y, col0 + r, N, c, d, vec4);
    }
  };
  auto stash = [&](int buf) {   // transposed: slice-major, row-minor
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int u = tid + l * kThreads;
      const int r = u / kQuads;
      const int c = (u % kQuads) * 4;
      sm.a[buf][c + 0][r] = va[l].x; sm.a[buf][c + 1][r] = va[l].y;
      sm.a[buf][c + 2][r] = va[l].z; sm.a[buf][c + 3][r] = va[l].w;
      sm.b[buf][c + 0][r] = vb[l].x; sm.b[buf][c + 1][r] = vb[l].y;
      sm.b[buf][c + 2][r] = vb[l].z; sm.b[buf][c + 3][r] = vb[l].w;
    }
  };

  fetch(0);
  stash(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < d; k0 += kBK) {
    const bool more = k0 + kBK < d;
    if (more) fetch(k0 + kBK);          // in flight during the FMAs below
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[buf][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sm.a[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sm.b[buf][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sm.b[buf][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read in the previous step, which every
    // thread finished before the barrier that ended it
    if (more) stash(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
}

// The squared norms of the thread's eight tile columns (0 past N).
__device__ __forceinline__ void tile_col_norms(const float* __restrict__ yn,
                                               int N, long long col0, int tx,
                                               float (&ync)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const long long c = col0 + tile_col(tx, j);
    ync[j] = c < N ? __ldg(yn + c) : 0.f;
  }
}

}  // namespace repro_tile
