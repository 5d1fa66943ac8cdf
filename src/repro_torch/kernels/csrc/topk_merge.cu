// Hand-written Hopper (sm_90a) top-k merge kernel.
//
// repro_topk_merge — replaces the Pallas kernel
// repro/kernels/topk_merge.py::topk_merge_pallas.
// Merges a sorted (B, L) beam of f32 distances and int32 ids with (B, K)
// candidates and keeps the L smallest in ascending order. Ties go to the
// beam, then to the lower candidate slot (the stable-sort order of the
// plain version). Slots whose distance is +inf come back as (+inf,
// NO_NODE). Ids are carried as int32 (the Pallas kernel carries them
// through f32, exact only below 2^24).
//
// Bound: it reads (L + K) x 8 bytes and writes L x 8 bytes per row, and
// does (L + K) x (L + K) compares per row; at L = K = 48 both are tiny
// next to the distance block each merge follows, so launch latency bounds
// it. Design: the rank-select of the TPU kernel without its one-hot
// matmuls — one block per row stages the row's L + K distances in shared
// memory; each thread computes one element's rank in the merged order by
// counting (beam i: i + #{candidates strictly smaller}; candidate j:
// #{beam <= it} + #{candidates smaller, or equal in a lower slot}), and
// writes the element to that rank if it is below L. With a sorted beam the
// ranks are a permutation, so every output slot is written exactly once.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void topk_merge_kernel(const float* __restrict__ bd,
                                  const int* __restrict__ bi,
                                  const float* __restrict__ cd,
                                  const int* __restrict__ ci,
                                  float* __restrict__ od, int* __restrict__ oi,
                                  int L, int K) {
  extern __shared__ float sd[];               // [0, L) beam, [L, L+K) cands
  const long long row = blockIdx.x;
  const int M = L + K;
  for (int e = threadIdx.x; e < M; e += blockDim.x)
    sd[e] = e < L ? __ldg(bd + row * L + e) : __ldg(cd + row * K + (e - L));
  __syncthreads();
  for (int e = threadIdx.x; e < M; e += blockDim.x) {
    const float v = sd[e];
    int rank;
    int id;
    if (e < L) {
      rank = e;
      for (int j = 0; j < K; ++j) rank += sd[L + j] < v;
      id = __ldg(bi + row * L + e);
    } else {
      const int j = e - L;
      rank = 0;
      for (int i = 0; i < L; ++i) rank += sd[i] <= v;
      for (int m = 0; m < K; ++m) {
        const float w = sd[L + m];
        rank += (w < v) || (w == v && m < j);
      }
      id = __ldg(ci + row * K + j);
    }
    if (rank < L) {
      const bool empty = v == INFINITY;
      od[row * L + rank] = v;
      oi[row * L + rank] = empty ? -1 : id;
    }
  }
}

}  // namespace

extern "C" int repro_topk_merge(const float* bd, const int* bi, const float* cd,
                                const int* ci, float* od, int* oi, int B, int L,
                                int K, void* stream) {
  const int M = L + K;
  int threads = ((M + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  topk_merge_kernel<<<B, threads, M * sizeof(float),
                      static_cast<cudaStream_t>(stream)>>>(bd, bi, cd, ci, od,
                                                           oi, L, K);
  return static_cast<int>(cudaGetLastError());
}
