// Hand-written Hopper (sm_90a) kernels for 1-bit sketch (Hamming) distances
// over SketchStore codes (repro_torch/quant/sketch.py): sign bits packed 32
// to a word, held as int32 words with the reference's uint32 bit patterns.
// Both kernels XOR the words and count the set bits with __popc, summed
// over the W = ceil(d/32) words of a row in int32. Hamming counts turn into
// certified L2 lower bounds outside the kernels (quant/sketch.py).
//
// Built by kernels/_build.py with nvcc into the port's shared library with
// a plain C interface and bound with ctypes. Every entry point launches on
// the stream it is given, allocates nothing, and returns cudaGetLastError().
// Any B, N, K and W are taken (the wrapper returns empty outputs itself).
//
// 1. repro_pairwise_hamming — replaces the Pallas kernel
//    repro/kernels/bits.py::pairwise_hamming_pallas.
//    out[b, n] = sum_w popc(cx[b, w] ^ cy[n, w]).
//    Bound: at the sketch NLJ's block (512 queries x 1M rows, W = 4) the
//    int32 output (2 GiB) is ~95% of the bytes; the XOR/popcounts are
//    integer work far below the SMs' rate, so the output write bounds it.
//    Design: a 64 x 128 output tile per 256-thread block, a 4 x 8 register
//    tile per thread; both operands' words are staged word-major in shared
//    memory (32 words at a time), and each thread writes 16-byte vectors
//    of 4 adjacent columns where the row length allows, so a warp's stores
//    cover whole 256-byte runs.
//
// 2. repro_rowwise_hamming — replaces
//    repro/kernels/bits.py::rowwise_hamming_pallas.
//    out[b, k] = sum_w popc(cx[b, w] ^ c[b, k, w]).
//    Two entries share one kernel: the (B, K, W) candidate tensor the TPU
//    kernel takes (ids == nullptr), and a gather form that reads candidate
//    row ids[b, k] of the code table itself, so the (B, K, W) tensor the JAX
//    traversal gathers is never built; an id outside [0, N) (NO_NODE) reads
//    no row and gives -1, which the sketch bound turns into +inf.
//    Bound: bytes — each candidate row (W x 4 bytes) is read once.
//    Design: one thread per (query, candidate) pair, 16-byte loads of the
//    row's words where W % 4 == 0 and the bases are aligned.
//
// 2'. repro_gather_sketch_bounds — the gather form of entry 2 with the
//    sketch tier's bounds fused in (quant/cascade.py SketchTier.
//    gather_bounds): per pair it reads the id, XORs and popcounts the W
//    words, finds the checkpoint k = max{k : hs[k] <= h} in the hs table
//    staged in shared memory, reads the two slack entries cum[id, k] and
//    cum[id, Kc-1] and the query's cum_q[b, k] and cum_q[b, Kc-1], and
//    writes the certified lower bound and the SimHash navigation estimate
//    (+inf for both at an id outside [0, N)). The eager composition it
//    replaces (kernels/ref.py gather_sketch_bounds: entry 2, then
//    quant/sketch.py sketch_lower_bound_gather, then the estimate) ran
//    ~50 device ops a traversal iteration.
//    Every f32 step is one __fadd_rn / __fsub_rn / __fmul_rn / __fsqrt_rn
//    in the composition's order (no FMA contraction), max and clamp pass
//    NaN on as torch's do, the division by d is torch's CUDA one (a
//    multiplication by the f32 reciprocal, which the wrapper passes), and
//    cos is the CUDA math library's cosf, which torch's CUDA cos calls:
//    lb and est are the composition's on the card, bit for bit.
//    Bound: bytes — each valid candidate's code row (W x 4 bytes), its two
//    slack entries and its id are read, and two f32 outputs written.
//    Design: one thread per pair, as entry 2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 128;
constexpr int kWChunk = 32;              // words staged per step
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pairwise_hamming_kernel(const int* __restrict__ cx, const int* __restrict__ cy,
                        int* __restrict__ out, int B, int N, int W, int vec4) {
  __shared__ __align__(16) int Xs[kWChunk][kBM];
  __shared__ __align__(16) int Ys[kWChunk][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long row0 = (long long)blockIdx.y * kBM;
  const long long col0 = (long long)blockIdx.x * kBN;

  int acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;

  for (int w0 = 0; w0 < W; w0 += kWChunk) {
    const int nw = min(kWChunk, W - w0);
    // stage words [w0, w0 + nw) of the tile's rows, zero past the edges
    // (consecutive threads take consecutive rows of one word: no bank
    // conflicts on the shared-memory side)
    for (int e = tid; e < nw * kBM; e += kThreads) {
      const int r = e % kBM, w = e / kBM;
      const long long gr = row0 + r;
      Xs[w][r] = gr < B ? __ldg(cx + gr * W + w0 + w) : 0;
    }
    for (int e = tid; e < nw * kBN; e += kThreads) {
      const int r = e % kBN, w = e / kBN;
      const long long gc = col0 + r;
      Ys[w][r] = gc < N ? __ldg(cy + gc * W + w0 + w) : 0;
    }
    __syncthreads();
    for (int w = 0; w < nw; ++w) {
      const int4 a = *reinterpret_cast<const int4*>(&Xs[w][ty * 4]);
      const int4 b0 = *reinterpret_cast<const int4*>(&Ys[w][tx * 4]);
      const int4 b1 = *reinterpret_cast<const int4*>(&Ys[w][64 + tx * 4]);
      const int av[4] = {a.x, a.y, a.z, a.w};
      const int bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += __popc(av[i] ^ bv[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = row0 + ty * 4 + i;
    if (r >= B) continue;
    int* orow = out + r * (long long)N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long c = col0 + h * 64 + tx * 4;
      if (vec4 && c + 3 < N) {
        *reinterpret_cast<int4*>(orow + c) = make_int4(
            acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
            acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < N) orow[c + j] = acc[i][4 * h + j];
      }
    }
  }
}

// cands: the (B, K, W) code tensor when ids == nullptr, else the (N, W)
// code table read at ids[pair]. vec4: W % 4 == 0 and 16-byte aligned bases.
__global__ void __launch_bounds__(kThreads)
rowwise_hamming_kernel(const int* __restrict__ cx, const int* __restrict__ cands,
                       const int* __restrict__ ids, int* __restrict__ out,
                       long long n_pairs, int K, int W, long long N, int vec4) {
  const long long pair = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (pair >= n_pairs) return;
  const int* c;
  if (ids != nullptr) {
    const int id = __ldg(ids + pair);
    if (id < 0 || (long long)id >= N) {
      out[pair] = -1;
      return;
    }
    c = cands + (long long)id * W;
  } else {
    c = cands + pair * (long long)W;
  }
  const int* q = cx + (pair / K) * (long long)W;
  int h = 0;
  if (vec4) {
    for (int w = 0; w < W; w += 4) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(c + w));
      const int4 b = __ldg(reinterpret_cast<const int4*>(q + w));
      h += __popc(a.x ^ b.x) + __popc(a.y ^ b.y) + __popc(a.z ^ b.z) +
           __popc(a.w ^ b.w);
    }
  } else {
    for (int w = 0; w < W; ++w) h += __popc(__ldg(c + w) ^ __ldg(q + w));
  }
  out[pair] = h;
}

// torch's clamp_min(v, 0) and maximum(a, b) on the card: NaN passes on
__device__ __forceinline__ float clamp0(float v) {
  return isnan(v) ? v : fmaxf(v, 0.f);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// vec4: W % 4 == 0 and 16-byte aligned bases. iso is the store's () f32
// factor, read on the card; guard = _GUARD + _GUARD_PER_DIM * d, pi_f =
// (float)pi and inv_d = 1.0f / d as the composition's f32 scalars.
__global__ void __launch_bounds__(kThreads)
gather_sketch_bounds_kernel(const int* __restrict__ codes,
                            const int* __restrict__ cx,
                            const int* __restrict__ ids,
                            const float* __restrict__ cum_q,
                            const float* __restrict__ cum_table,
                            const int* __restrict__ hs,
                            const float* __restrict__ iso,
                            float* __restrict__ lb, float* __restrict__ est,
                            int n_pairs, int K, int W, int N, int Kc,
                            float guard, float pi_f, float inv_d, int vec4) {
  extern __shared__ int hs_s[];
  for (int i = threadIdx.x; i < Kc; i += kThreads) hs_s[i] = __ldg(hs + i);
  __syncthreads();
  const int pair = blockIdx.x * kThreads + threadIdx.x;
  if (pair >= n_pairs) return;
  const int id = __ldg(ids + pair);
  if (id < 0 || id >= N) {
    lb[pair] = INFINITY;
    est[pair] = INFINITY;
    return;
  }
  const int b = pair / K;
  const int* c = codes + (long long)id * W;
  const int* q = cx + (long long)b * W;
  int h = 0;
  if (vec4) {
    for (int w = 0; w < W; w += 4) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(c + w));
      const int4 e = __ldg(reinterpret_cast<const int4*>(q + w));
      h += __popc(a.x ^ e.x) + __popc(a.y ^ e.y) + __popc(a.z ^ e.z) +
           __popc(a.w ^ e.w);
    }
  } else {
    for (int w = 0; w < W; ++w) h += __popc(__ldg(c + w) ^ __ldg(q + w));
  }
  // the count of checkpoints <= h, less one (torch.searchsorted, right)
  int lo = 0, hi = Kc;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (hs_s[mid] <= h) lo = mid + 1;
    else hi = mid;
  }
  const int k = max(lo - 1, 0);
  const float* cq_row = cum_q + (long long)b * Kc;
  const float* cc_row = cum_table + (long long)id * Kc;
  const float cq = __ldg(cq_row + k), nq = __ldg(cq_row + Kc - 1);
  const float cc = __ldg(cc_row + k), nc = __ldg(cc_row + Kc - 1);
  // _lb_from_cum: lb1 = cq + cc; lb2 = (nq + nc) - 2·√((nq−cq)⁺·(nc−cc)⁺)
  const float energy = __fadd_rn(nq, nc);
  const float lb1 = __fadd_rn(cq, cc);
  const float slack = __fmul_rn(clamp0(__fsub_rn(nq, cq)),
                                clamp0(__fsub_rn(nc, cc)));
  const float lb2 = __fsub_rn(energy, __fmul_rn(2.f, __fsqrt_rn(slack)));
  const float l = clamp0(nan_max(lb1, lb2));
  const float out = clamp0(__fsub_rn(__fmul_rn(__ldg(iso), l),
                                     __fmul_rn(guard, energy)));
  lb[pair] = out;
  // the estimate (nq + nc) − (2·√max(nq·nc, 0))·cos(π·h/d)
  const float ang = __fmul_rn(__fmul_rn(pi_f, static_cast<float>(h)), inv_d);
  const float root = __fsqrt_rn(clamp0(__fmul_rn(nq, nc)));
  const float e = __fsub_rn(energy, __fmul_rn(__fmul_rn(2.f, root), cosf(ang)));
  est[pair] = isfinite(out) ? e : INFINITY;
}

}  // namespace

extern "C" int repro_pairwise_hamming(const int* cx, const int* cy, int* out,
                                      int B, int N, int W, int vec4,
                                      void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  pairwise_hamming_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      cx, cy, out, B, N, W, vec4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_rowwise_hamming(const int* cx, const int* cands,
                                     const int* ids, int* out,
                                     long long n_pairs, int K, int W,
                                     long long N, int vec4, void* stream) {
  const long long blocks = (n_pairs + kThreads - 1) / kThreads;
  rowwise_hamming_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      cx, cands, ids, out, n_pairs, K, W, N, vec4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_gather_sketch_bounds(
    const int* codes, const int* cx, const int* ids, const float* cum_q,
    const float* cum_table, const int* hs, const float* iso, float* lb,
    float* est, int n_pairs, int K, int W, int N, int Kc, float guard,
    float pi_f, float inv_d, int vec4, void* stream) {
  const int blocks = (n_pairs + kThreads - 1) / kThreads;
  gather_sketch_bounds_kernel<<<blocks, kThreads, Kc * sizeof(int),
                                static_cast<cudaStream_t>(stream)>>>(
      codes, cx, ids, cum_q, cum_table, hs, iso, lb, est, n_pairs, K, W, N,
      Kc, guard, pi_f, inv_d, vec4);
  return static_cast<int>(cudaGetLastError());
}
