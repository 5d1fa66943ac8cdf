// Hand-written Hopper (sm_90a) kernels for the join's distance hot spot.
//
// Built by kernels/_build.py with nvcc into a shared library with a plain
// C interface (no PyTorch headers) and bound with ctypes. Every entry point
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
//
// 1. repro_pairwise_sq_dists — replaces the Pallas kernel
//    repro/kernels/distance.py::pairwise_sq_dists_pallas.
//    out[b, n] = max(xn[b] + yn[n] - 2 * <x_b, y_n>, 0), (B,d) x (N,d) -> (B,N).
//    Bound: with d = 128 the product does 2·B·N·d FLOP for 4 output bytes
//    per element (64 FLOP/byte, above the H100's f32 ridge of ~20), so it
//    is bound by the f32 FMA rate. The join needs IEEE f32 (TF32 moves
//    pairs on the θ boundary), so the tensor cores are not used. Design:
//    a CUDA-core SGEMM tile (tile.cuh, shared with nlj.cu) — 128x128
//    outputs per 256-thread block, two blocks an SM, an 8x8 register tile
//    per thread from float4 reads of k-major shared slices, the next slice
//    loaded into registers while the current one is multiplied (double
//    buffered, one barrier a slice), fmaf accumulation. The distance
//    epilogue is fused into the store: each thread writes its row's two
//    runs of 4 columns as 16-byte stores, so a half-warp writes 256
//    contiguous bytes (scalar stores only where N % 4 != 0 or at the
//    ragged edge). Ragged B, N and d edges are masked in the kernel (loads
//    read 0, stores are skipped), so the wrapper never pads. Norms come
//    from the caller.
//
// 2. repro_rowwise_sq_dists — replaces
//    repro/kernels/distance.py::rowwise_sq_dists_pallas.
//    out[b, k] = sum_i (c[b,k,i] - x[b,i])^2, (B,d) x (B,K,d) -> (B,K).
//    Bound: each candidate row is used once, so the bytes moved. Design:
//    one warp per (query, candidate) pair; lane l sums the float4 slots
//    l, l+32, ... of the row (one coalesced 512-byte read at d = 128; a
//    scalar loop when d % 4 != 0) as one fmaf chain, then an xor-tree of
//    shuffles (offsets 16, 8, 4, 2, 1) adds the 32 partials.
// 3. repro_gather_sq_dists — replaces
//    repro/kernels/gather_distance.py::gather_sq_dists_pallas.
//    out[p] = sum_i (vecs[idx[p], i] - x[q(p), i])^2 with q(p) = p / K for
//    the (B, K) id matrix the traversal probes with, or q(p) = qi[p] for a
//    pair list (the NLJ's band re-rank: no copy of the pairs' query rows);
//    +inf where idx (or qi) is out of range (NO_NODE), with no row read.
//    Bound: each candidate row is used once, so the bytes moved (rows +
//    queries + ids + outputs over HBM bandwidth). At the traversal's shape
//    (256 x 128 ids, half NO_NODE, ~8 MB of rows) that is ~2.5 us: the
//    latency of the id -> row chain, not the bandwidth, sets the time.
//    Design: a warp owns a run of 8 pairs. Lanes 0-7 read the run's ids
//    (and query rows) with one coalesced load, a ballot drops the NO_NODE
//    slots before any row read (a run with none valid reads no row), and
//    every lane then issues its float4 slot of all 8 rows before summing
//    any (4 KB of a warp in flight at d = 128), with the query row read
//    once per run while the pairs share it. Each lane's slots and fmaf
//    order, and the xor-tree of the reduction, are the rowwise kernel's
//    (2), so the values are bit for bit the one-warp-a-pair kernel's; the
//    tree runs on the 8 sums at once (a lane keeps half of its sums and
//    trades the other half at the first levels: 5 shuffles, not 40).
//    repro_gather_sq_dists_bf16 is its entry for bf16 rows and queries
//    (the reference's gather upcasts bf16 vectors to f32 before the
//    difference form, repro/kernels/ref.py rowwise_sq_dists): the same
//    warp-a-run design, each lane reading 16 bytes (8 values) of a row a
//    slot, each value widened to f32 exactly (its bits shifted up), the
//    differences, squares and sums in f32. It reads half the f32 entry's
//    bytes for the same arithmetic, so it is bound by those bytes too;
//    no tensor cores (the difference form has no product to give them).
// 4. repro_pairlist_sq_dists — the pair-list entry of (1): out[p] =
//    max(xn[qi[p]] + yn[yi[p]] - 2 * <x_qi, y_yi>, 0) for explicit
//    (query, data) id pairs. It exists so that an exact re-rank of a
//    sparse survivor set (the sq8 cascade kNN build) reproduces the tile
//    kernel's values bit for bit: both accumulate the dot as one fmaf
//    chain over dimensions 0..d-1 from 0 and finish with the same
//    dist_epilogue (tile.cuh), and the caller passes the
//    same norm tensor to both. Design: a warp takes 32 pairs; it stages
//    32-float slices of their rows in shared memory with coalesced loads,
//    then each lane runs its own pair's fmaf chain over the slice in
//    order. Bound: the bytes of the gathered rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile.cuh"

namespace {

using repro_tile::dist_epilogue;
using repro_tile::kBM;
using repro_tile::kBN;
using repro_tile::kThreads;

__global__ void __launch_bounds__(kThreads, 2)
pairwise_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ xn, const float* __restrict__ yn,
                float* __restrict__ out, int B, int N, int d, int vec4,
                int vec_out) {
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
    if (r >= B) continue;
    const float xr = __ldg(xn + r);
    float* orow = out + r * (long long)N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long c = col0 + repro_tile::tile_col(tx, 4 * h);
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = dist_epilogue(xr, ync[4 * h + j], acc[i][4 * h + j]);
      if (vec_out && c + 3 < N) {
        *reinterpret_cast<float4*>(orow + c) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < N) orow[c + j] = v[j];
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Squared L2 distance between row c and row q, reduced over the warp
// (every lane returns the total).
__device__ __forceinline__ float warp_row_sq_dist(const float* __restrict__ c,
                                                  const float* __restrict__ q,
                                                  int d, int vec4, int lane) {
  float acc = 0.f;
  if (vec4) {
    const float4* c4 = reinterpret_cast<const float4*>(c);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const int d4 = d >> 2;
    for (int i = lane; i < d4; i += 32) {
      const float4 a = __ldg(c4 + i);
      const float4 b = __ldg(q4 + i);
      float t = a.x - b.x; acc = fmaf(t, t, acc);
      t = a.y - b.y; acc = fmaf(t, t, acc);
      t = a.z - b.z; acc = fmaf(t, t, acc);
      t = a.w - b.w; acc = fmaf(t, t, acc);
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float t = __ldg(c + i) - __ldg(q + i);
      acc = fmaf(t, t, acc);
    }
  }
  return warp_sum(acc);
}

__global__ void __launch_bounds__(kThreads)
rowwise_kernel(const float* __restrict__ x, const float* __restrict__ cands,
               float* __restrict__ out, long long n_pairs, int K, int d,
               int vec4) {
  const long long pair = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (pair >= n_pairs) return;  // uniform across the warp
  const long long b = pair / K;
  const float s = warp_row_sq_dist(cands + pair * d, x + b * d, d, vec4, lane);
  if (lane == 0) out[pair] = s;
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGatherWarps = 4;      // warps a block
constexpr int kRun = 8;              // pairs a warp owns

// warp_sum's xor-tree run on kRun sums at once. At the first levels
// (offsets 16, 8, 4) a lane keeps half of its sums and sends the other
// half to its partner, then the one left goes on as in warp_sum: every
// sum still adds each partial pair as own + partner's at the same level
// as warp_sum does, so the totals are warp_sum's bit for bit (in 3 + 2
// shuffles for 8 sums, not 40). Lane l ends with the total of sum l >> 2.
__device__ __forceinline__ float warp_sum_run(float (&v)[kRun], int lane) {
  int o = 16;
#pragma unroll
  for (int h = kRun / 2; h >= 1; h >>= 1, o >>= 1) {
    const bool up = lane & o;
#pragma unroll
    for (int k = 0; k < h; ++k) {
      const float send = up ? v[k] : v[k + h];
      const float keep = up ? v[k + h] : v[k];
      v[k] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, o));
    }
  }
  float s = v[0];
#pragma unroll
  for (; o >= 1; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
  return s;
}

// idx: the pairs' candidate ids; qi: their query rows (pair list), or
// nullptr for the (B, K) form (query row p / K). VEC4: d % 4 == 0 and
// 16-byte aligned bases (lane l takes float4 slots l, l+32, ...), else
// lane l takes floats l, l+32, ... — warp_row_sq_dist's two mappings.
template <bool VEC4>
__global__ void __launch_bounds__(kGatherWarps * 32)
gather_kernel(const float* __restrict__ vecs, const float* __restrict__ x,
              const int* __restrict__ idx, const int* __restrict__ qi,
              float* __restrict__ out, long long n_pairs, int K, int d,
              long long N, int B) {
  const int lane = threadIdx.x & 31;
  const long long p0 =
      ((long long)blockIdx.x * kGatherWarps + threadIdx.x / 32) * kRun;
  if (p0 >= n_pairs) return;           // uniform across the warp
  const long long p = p0 + (lane & (kRun - 1));
  const bool in = lane < kRun && p < n_pairs;
  int id = 0, q = 0;
  bool ok = false;
  if (in) {                            // n_pairs < 2^31: 32-bit division
    id = __ldg(idx + p);
    q = qi != nullptr ? __ldg(qi + p)
                      : (int)(static_cast<unsigned>(p) /
                              static_cast<unsigned>(K));
    ok = id >= 0 && (long long)id < N && q >= 0 && q < B;
  }
  const unsigned valid = __ballot_sync(kFull, ok);
  if (valid == 0u) {                   // NO_NODE only: no row is read
    if (in) out[p] = INFINITY;
    return;
  }
  if (!ok) id = q = 0;                 // a slot that reads nothing
  int idr[kRun], qr[kRun];
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    idr[r] = __shfl_sync(kFull, id, r);
    qr[r] = __shfl_sync(kFull, q, r);
  }
  float acc[kRun];
#pragma unroll
  for (int r = 0; r < kRun; ++r) acc[r] = 0.f;
  if (VEC4) {
    const int d4 = d >> 2;
    const float4* v4 = reinterpret_cast<const float4*>(vecs);
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int i = lane; i < d4; i += 32) {
      float4 c[kRun];                  // every row's slot in flight first
#pragma unroll
      for (int r = 0; r < kRun; ++r)
        c[r] = (valid >> r) & 1u ? __ldg(v4 + (long long)idr[r] * d4 + i)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 b = __ldg(x4 + (long long)qr[0] * d4 + i);
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        if (r > 0 && qr[r] != qr[r - 1])
          b = __ldg(x4 + (long long)qr[r] * d4 + i);
        float t = c[r].x - b.x; acc[r] = fmaf(t, t, acc[r]);
        t = c[r].y - b.y; acc[r] = fmaf(t, t, acc[r]);
        t = c[r].z - b.z; acc[r] = fmaf(t, t, acc[r]);
        t = c[r].w - b.w; acc[r] = fmaf(t, t, acc[r]);
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      float c[kRun];
#pragma unroll
      for (int r = 0; r < kRun; ++r)
        c[r] = (valid >> r) & 1u ? __ldg(vecs + (long long)idr[r] * d + i)
                                 : 0.f;
      float b = __ldg(x + (long long)qr[0] * d + i);
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        if (r > 0 && qr[r] != qr[r - 1])
          b = __ldg(x + (long long)qr[r] * d + i);
        const float t = c[r] - b;
        acc[r] = fmaf(t, t, acc[r]);
      }
    }
  }
  const float s = warp_sum_run(acc, lane);
  const int m = lane >> 2;             // the pair whose total this lane holds
  if ((lane & 3) == 0 && p0 + m < n_pairs)
    out[p0 + m] = (valid >> m) & 1u ? s : INFINITY;
}

// d += (c - q)^2 over the 8 bf16 values of a 16-byte slot, in index
// order; a bf16 is the high half of its f32, so widening is a shift.
__device__ __forceinline__ float sq_diff8(uint4 c, uint4 q, float acc) {
  const unsigned cw[4] = {c.x, c.y, c.z, c.w};
  const unsigned qw[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float t = __uint_as_float(cw[j] << 16) - __uint_as_float(qw[j] << 16);
    acc = fmaf(t, t, acc);
    t = __uint_as_float(cw[j] & 0xffff0000u) -
        __uint_as_float(qw[j] & 0xffff0000u);
    acc = fmaf(t, t, acc);
  }
  return acc;
}

// The (B, K) gather over bf16 rows and queries (query row p / K). VEC8:
// d % 8 == 0 and 16-byte aligned bases (lane l takes the 8-value slots
// l, l+32, ...), else lane l takes values l, l+32, ...
template <bool VEC8>
__global__ void __launch_bounds__(kGatherWarps * 32)
gather_bf16_kernel(const __nv_bfloat16* __restrict__ vecs,
                   const __nv_bfloat16* __restrict__ x,
                   const int* __restrict__ idx, float* __restrict__ out,
                   long long n_pairs, int K, int d, long long N, int B) {
  const int lane = threadIdx.x & 31;
  const long long p0 =
      ((long long)blockIdx.x * kGatherWarps + threadIdx.x / 32) * kRun;
  if (p0 >= n_pairs) return;           // uniform across the warp
  const long long p = p0 + (lane & (kRun - 1));
  const bool in = lane < kRun && p < n_pairs;
  int id = 0, q = 0;
  bool ok = false;
  if (in) {                            // n_pairs < 2^31: 32-bit division
    id = __ldg(idx + p);
    q = (int)(static_cast<unsigned>(p) / static_cast<unsigned>(K));
    ok = id >= 0 && (long long)id < N && q < B;
  }
  const unsigned valid = __ballot_sync(kFull, ok);
  if (valid == 0u) {                   // NO_NODE only: no row is read
    if (in) out[p] = INFINITY;
    return;
  }
  if (!ok) id = q = 0;                 // a slot that reads nothing
  int idr[kRun], qr[kRun];
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    idr[r] = __shfl_sync(kFull, id, r);
    qr[r] = __shfl_sync(kFull, q, r);
  }
  float acc[kRun];
#pragma unroll
  for (int r = 0; r < kRun; ++r) acc[r] = 0.f;
  if (VEC8) {
    const int d8 = d >> 3;
    const uint4* v8 = reinterpret_cast<const uint4*>(vecs);
    const uint4* x8 = reinterpret_cast<const uint4*>(x);
    for (int i = lane; i < d8; i += 32) {
      uint4 c[kRun];                   // every row's slot in flight first
#pragma unroll
      for (int r = 0; r < kRun; ++r)
        c[r] = (valid >> r) & 1u ? __ldg(v8 + (long long)idr[r] * d8 + i)
                                 : make_uint4(0u, 0u, 0u, 0u);
      uint4 b = __ldg(x8 + (long long)qr[0] * d8 + i);
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        if (r > 0 && qr[r] != qr[r - 1])
          b = __ldg(x8 + (long long)qr[r] * d8 + i);
        acc[r] = sq_diff8(c[r], b, acc[r]);
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      float c[kRun];
#pragma unroll
      for (int r = 0; r < kRun; ++r)
        c[r] = (valid >> r) & 1u
                   ? __bfloat162float(vecs[(long long)idr[r] * d + i])
                   : 0.f;
      float b = __bfloat162float(x[(long long)qr[0] * d + i]);
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        if (r > 0 && qr[r] != qr[r - 1])
          b = __bfloat162float(x[(long long)qr[r] * d + i]);
        const float t = c[r] - b;
        acc[r] = fmaf(t, t, acc[r]);
      }
    }
  }
  const float s = warp_sum_run(acc, lane);
  const int m = lane >> 2;             // the pair whose total this lane holds
  if ((lane & 3) == 0 && p0 + m < n_pairs)
    out[p0 + m] = (valid >> m) & 1u ? s : INFINITY;
}

constexpr int kPairWarps = 4;

__global__ void __launch_bounds__(kPairWarps * 32)
pairlist_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ xn, const float* __restrict__ yn,
                const int* __restrict__ qi, const int* __restrict__ yi,
                float* __restrict__ out, long long P, int d, long long B,
                long long N) {
  __shared__ float xs[kPairWarps][32][33];
  __shared__ float ys[kPairWarps][32][33];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const long long p = ((long long)blockIdx.x * kPairWarps + warp) * 32 + lane;
  const bool in = p < P;
  const int q = in ? __ldg(qi + p) : -1;
  const int j = in ? __ldg(yi + p) : -1;
  const int ok = in && q >= 0 && q < B && j >= 0 && j < N;
  float acc = 0.f;
  for (int c0 = 0; c0 < d; c0 += 32) {
    const int k = c0 + lane;
    for (int r = 0; r < 32; ++r) {   // coalesced: the warp reads row r's slice
      const int qr = __shfl_sync(0xffffffffu, q, r);
      const int jr = __shfl_sync(0xffffffffu, j, r);
      const int okr = __shfl_sync(0xffffffffu, ok, r);
      const bool ld = okr && k < d;
      xs[warp][r][lane] = ld ? __ldg(x + (long long)qr * d + k) : 0.f;
      ys[warp][r][lane] = ld ? __ldg(y + (long long)jr * d + k) : 0.f;
    }
    __syncwarp();
    const int kn = min(32, d - c0);
    for (int t = 0; t < kn; ++t) acc = fmaf(xs[warp][lane][t], ys[warp][lane][t], acc);
    __syncwarp();
  }
  if (in) out[p] = ok ? dist_epilogue(__ldg(xn + q), __ldg(yn + j), acc) : INFINITY;
}

}  // namespace

extern "C" int repro_pairwise_sq_dists(const float* x, const float* y,
                                       const float* xn, const float* yn,
                                       float* out, int B, int N, int d,
                                       int vec4, void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  // 16-byte stores need every output row 16-byte aligned
  const int vec_out = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  pairwise_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, xn, yn, out, B, N, d, vec4, vec_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_rowwise_sq_dists(const float* x, const float* cands,
                                      float* out, long long n_pairs, int K,
                                      int d, int vec4, void* stream) {
  const long long blocks = (n_pairs + kThreads / 32 - 1) / (kThreads / 32);
  rowwise_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(x, cands, out, n_pairs,
                                                        K, d, vec4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_gather_sq_dists(const float* vecs, const float* x,
                                     const int* idx, const int* qi, float* out,
                                     long long n_pairs, int K, int d,
                                     long long N, int B, int vec4,
                                     void* stream) {
  const long long per_block = kGatherWarps * kRun;
  const unsigned blocks =
      static_cast<unsigned>((n_pairs + per_block - 1) / per_block);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec4)
    gather_kernel<true><<<blocks, kGatherWarps * 32, 0, st>>>(
        vecs, x, idx, qi, out, n_pairs, K, d, N, B);
  else
    gather_kernel<false><<<blocks, kGatherWarps * 32, 0, st>>>(
        vecs, x, idx, qi, out, n_pairs, K, d, N, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_gather_sq_dists_bf16(const void* vecs, const void* x,
                                          const int* idx, float* out,
                                          long long n_pairs, int K, int d,
                                          long long N, int B, int vec8,
                                          void* stream) {
  const long long per_block = kGatherWarps * kRun;
  const unsigned blocks =
      static_cast<unsigned>((n_pairs + per_block - 1) / per_block);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(vecs);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(x);
  if (vec8)
    gather_bf16_kernel<true><<<blocks, kGatherWarps * 32, 0, st>>>(
        v, q, idx, out, n_pairs, K, d, N, B);
  else
    gather_bf16_kernel<false><<<blocks, kGatherWarps * 32, 0, st>>>(
        v, q, idx, out, n_pairs, K, d, N, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_pairlist_sq_dists(const float* x, const float* y,
                                       const float* xn, const float* yn,
                                       const int* qi, const int* yi, float* out,
                                       long long P, int d, long long B,
                                       long long N, void* stream) {
  const long long per_block = kPairWarps * 32;
  const long long blocks = (P + per_block - 1) / per_block;
  pairlist_kernel<<<static_cast<unsigned>(blocks), kPairWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(x, y, xn, yn, qi, yi,
                                                         out, P, d, B, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
