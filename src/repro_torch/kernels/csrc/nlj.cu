// Hand-written Hopper (sm_90a) kernel for the exact nested-loop join's
// per-query match count.
//
// repro_nlj_count — replaces the Pallas kernel
// repro/kernels/nlj.py::nlj_count_pallas.
//   counts[b] = |{n : max(xn[b] + yn[n] - 2 * <x_b, y_n>, 0) < th2}|,
//   (B,d) x (N,d) -> (B,) int32; the caller zeroes counts and squares θ in
//   f32.
// Bound: 2·B·N·d FLOP against (B+N)·d·4 bytes in and B·4 out, so at d = 128
// it is bound by the f32 FMA rate (IEEE f32: TF32 would move pairs on the
// θ boundary). Design: the distance tile never leaves the registers, as
// the TPU kernel keeps it in VMEM. The dots come from the pairwise
// kernel's tile (tile.cuh: 128x128 per 256-thread block, two blocks an SM,
// 8x8 per thread, double-buffered slices, one fmaf chain per dot in k
// order) and go through the same dist_epilogue, so each comparison sees
// exactly the value the pairwise kernel would write. The epilogue compares with θ², sums each row's
// eight hits in registers, then across the 16 threads that share the row
// (lanes 0-15 or 16-31 of a warp) with xor shuffles, and one thread adds
// the row's tile total to counts[b] with one atomicAdd. Integer addition
// is exact in any order, so the counts do not depend on the atomics'
// order. Rows and columns past B and N are masked, never padded.

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

using repro_tile::kBM;
using repro_tile::kBN;
using repro_tile::kThreads;

__global__ void __launch_bounds__(kThreads, 2)
nlj_count_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ xn, const float* __restrict__ yn,
                 int* __restrict__ counts, int B, int N, int d, int vec4,
                 float th2) {
  __shared__ __align__(16) repro_tile::Smem sm;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long row0 = (long long)blockIdx.y * kBM;
  const long long col0 = (long long)blockIdx.x * kBN;
  float acc[8][8];
  repro_tile::tile_dots(x, y, B, N, d, vec4, row0, col0, sm, acc);
  float ync[8];
  repro_tile::tile_col_norms(yn, N, col0, tx, ync);

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = row0 + repro_tile::tile_row(ty, i);
    int hits = 0;
    if (r < B) {
      const float xr = __ldg(xn + r);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long c = col0 + repro_tile::tile_col(tx, j);
        if (c < N && repro_tile::dist_epilogue(xr, ync[j], acc[i][j]) < th2)
          ++hits;
      }
    }
    // the row's 16 threads are one half-warp (tile.cuh's thread mapping):
    // xor offsets below 16 stay in it
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) hits += __shfl_xor_sync(0xffffffffu, hits, o);
    if (tx == 0 && hits > 0) atomicAdd(counts + r, hits);
  }
}

}  // namespace

extern "C" int repro_nlj_count(const float* x, const float* y, const float* xn,
                               const float* yn, int* counts, int B, int N, int d,
                               int vec4, float th2, void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  nlj_count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, xn, yn, counts, B, N, d, vec4, th2);
  return static_cast<int>(cudaGetLastError());
}
