// Hand-written Hopper (sm_90a) top-k merge kernels.
//
// repro_topk_merge_warp / repro_topk_merge — replace the Pallas kernel
// repro/kernels/topk_merge.py::topk_merge_pallas.
// Merge a sorted (B, L) beam of f32 distances and int32 ids with (B, K)
// candidates and keep the L smallest in ascending order. Ties go to the
// beam, then to the lower candidate slot (the stable-sort order of the
// plain version). Slots whose distance is +inf come back as (+inf,
// NO_NODE). Ids are carried as int32 (the Pallas kernel carries them
// through f32, exact only below 2^24). The outputs are a permutation of
// inputs, so they equal the plain version's exactly.
//
// Bound: it reads (L + K) x 8 bytes and writes L x 8 bytes per row; at the
// kNN builds' call (B = 4096, L = K = 48, the candidates a block's k
// smallest in id order, unsorted) that is 2.4 MB, ~1.4 us at 3.35 TB/s,
// and the compares are few: latency and occupancy set the time.
//
// 1. repro_topk_merge_warp (L, K <= 64; the wrapper picks it by shape):
//    a warp owns a row, a block 8 rows (the TPU kernel's bm = 8), so 4096
//    rows are 512 blocks of 256 threads. Lane l holds slots 2l and 2l + 1:
//    the four inputs are loaded up front (8-byte loads where the rows are
//    8-byte aligned), the candidates are sorted in registers by (distance,
//    slot) with a warp bitonic network (64 keys, shuffles across lanes, a
//    swap within one), the sorted candidates and the beam go to the warp's
//    slice of shared memory, and lane l finds output 2l's co-rank in
//    (beam, sorted candidates) by a merge-path binary search, the beam
//    first on ties; output 2l + 1 is one merge step on. Lane l writes
//    outputs 2l and 2l + 1, so the stores are coalesced.
// 2. repro_topk_merge (any L + K up to what one block's shared memory
//    holds): one block per row stages the row's L + K distances in shared
//    memory; each thread computes one element's rank in the merged order
//    by counting (beam i: i + #{candidates strictly smaller}; candidate j:
//    #{beam <= it} + #{candidates smaller, or equal in a lower slot}), and
//    writes the element to that rank if it is below L. With a sorted beam
//    the ranks are a permutation, so every output slot is written once.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 8;
constexpr int kWarpMax = 64;          // L and K the warp kernel holds

// (d, s) before (d2, s2): by distance, then by slot
__device__ __forceinline__ bool key_less(float d, int s, float d2, int s2) {
  return d < d2 || (d == d2 && s < s2);
}

// slots 2·lane and 2·lane + 1 of a row of n, +inf past n
template <bool V2>
__device__ __forceinline__ void load2(const float* __restrict__ pd,
                                      const int* __restrict__ pi, int n,
                                      int lane, float (&d)[2], int (&id)[2]) {
  const int e = 2 * lane;
  if (V2 && e + 1 < n) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(pd + e));
    const int2 w = __ldg(reinterpret_cast<const int2*>(pi + e));
    d[0] = v.x; d[1] = v.y;
    id[0] = w.x; id[1] = w.y;
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    d[h] = e + h < n ? __ldg(pd + e + h) : INFINITY;
    id[h] = e + h < n ? __ldg(pi + e + h) : -1;
  }
}

// V2: L and K even and every base 8-byte aligned
template <bool V2>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
topk_merge_warp_kernel(const float* __restrict__ bd, const int* __restrict__ bi,
                       const float* __restrict__ cd, const int* __restrict__ ci,
                       float* __restrict__ od, int* __restrict__ oi, int B,
                       int L, int K) {
  __shared__ float sa[kRowsPerBlock][kWarpMax];   // the beam
  __shared__ int ia[kRowsPerBlock][kWarpMax];
  __shared__ float sb[kRowsPerBlock][kWarpMax];   // the sorted candidates
  __shared__ int ib[kRowsPerBlock][kWarpMax];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + w;
  if (row >= B) return;                // uniform over the warp; no barrier
  float a[2], c[2];
  int aid[2], cid[2];
  load2<V2>(bd + row * L, bi + row * L, L, lane, a, aid);
  load2<V2>(cd + row * K, ci + row * K, K, lane, c, cid);

  // bitonic sort of the 64 (distance, slot) keys, element e = 2·lane + h;
  // pads (slot >= K) are +inf in higher slots than any candidate
  int s[2] = {2 * lane, 2 * lane + 1};
#pragma unroll
  for (int k = 2; k <= kWarpMax; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 1) {                    // partners in one lane
        const bool asc = ((2 * lane) & k) == 0;
        if (asc ? key_less(c[1], s[1], c[0], s[0])
                : key_less(c[0], s[0], c[1], s[1])) {
          const float td = c[0]; c[0] = c[1]; c[1] = td;
          const int ts = s[0]; s[0] = s[1]; s[1] = ts;
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * lane + h;
          const float pd = __shfl_xor_sync(kFull, c[h], j >> 1);
          const int ps = __shfl_xor_sync(kFull, s[h], j >> 1);
          const bool keep_min = ((e & j) == 0) == ((e & k) == 0);
          if (keep_min ? key_less(pd, ps, c[h], s[h])
                       : key_less(c[h], s[h], pd, ps)) {
            c[h] = pd;
            s[h] = ps;
          }
        }
      }
    }
  }
  // the sorted candidates' ids, from the lanes that loaded them
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int v0 = __shfl_sync(kFull, cid[0], s[h] >> 1);
    const int v1 = __shfl_sync(kFull, cid[1], s[h] >> 1);
    const int e = 2 * lane + h;
    sa[w][e] = a[h];
    ia[w][e] = aid[h];
    sb[w][e] = c[h];
    ib[w][e] = (s[h] & 1) ? v1 : v0;
  }
  __syncwarp();

  // output 2·lane: its co-rank i (beam entries before it) by a merge-path
  // binary search (7 halvings cover the 65 possible co-ranks); output
  // 2·lane + 1 is the next merge step
  const int r = 2 * lane;
  int lo = max(0, r - K), hi = min(r, L);
#pragma unroll
  for (int it = 0; it < 7; ++it) {
    if (lo < hi) {
      const int mid = (lo + hi) >> 1;
      // beam entry mid precedes output r iff it is <= candidate r-1-mid
      if (sa[w][mid] <= sb[w][r - 1 - mid]) lo = mid + 1;
      else hi = mid;
    }
  }
  float v[2];
  int id[2];
  int i = lo, j = r - lo;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool beam = i < L && (j >= K || sa[w][min(i, kWarpMax - 1)] <=
                                              sb[w][min(j, kWarpMax - 1)]);
    // past the end (r >= L + K) both reads are clamped: never stored
    const int m = min(beam ? i : j, kWarpMax - 1);
    v[h] = beam ? sa[w][m] : sb[w][m];
    id[h] = v[h] == INFINITY ? -1 : (beam ? ia[w][m] : ib[w][m]);
    i += beam;
    j += !beam;
  }
  const int e = 2 * lane;
  float* orow = od + row * L;
  int* irow = oi + row * L;
  if (V2 && e + 1 < L) {
    *reinterpret_cast<float2*>(orow + e) = make_float2(v[0], v[1]);
    *reinterpret_cast<int2*>(irow + e) = make_int2(id[0], id[1]);
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (e + h < L) {
        orow[e + h] = v[h];
        irow[e + h] = id[h];
      }
  }
}

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

bool aligned8(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 8 == 0;
}

}  // namespace

extern "C" int repro_topk_merge_warp(const float* bd, const int* bi,
                                     const float* cd, const int* ci, float* od,
                                     int* oi, int B, int L, int K,
                                     void* stream) {
  if (L > kWarpMax || K > kWarpMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool v2 = L % 2 == 0 && K % 2 == 0 && aligned8(bd) && aligned8(bi) &&
                  aligned8(cd) && aligned8(ci) && aligned8(od) &&
                  aligned8(oi);
  if (v2)
    topk_merge_warp_kernel<true><<<blocks, kRowsPerBlock * 32, 0, st>>>(
        bd, bi, cd, ci, od, oi, B, L, K);
  else
    topk_merge_warp_kernel<false><<<blocks, kRowsPerBlock * 32, 0, st>>>(
        bd, bi, cd, ci, od, oi, B, L, K);
  return static_cast<int>(cudaGetLastError());
}

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
