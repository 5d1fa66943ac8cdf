// Hand-written Hopper (sm_90a) kernels for quantized (int8) squared-L2
// distances over QuantStore codes (per-dimension-group scaled int8, see
// repro_torch/quant/store.py). Both compute the quantized-domain distance
// d^ = ||x^ - y^||^2; certified bounds on the true distance are applied
// outside the kernels (kernels/ops.py: quant_lower_bound / upper_bound).
//
// Built by kernels/_build.py with nvcc into the port's shared library with
// a plain C interface and bound with ctypes. Every entry point launches on
// the stream it is given, allocates nothing, and returns cudaGetLastError().
// Any d is taken, including d < group_size and d % group_size != 0: the
// dimensions past d count 0, and the wrapper pads nothing.
//
// 1. repro_pairwise_sq_dists_int8 — replaces the Pallas kernel
//    repro/kernels/int8.py::pairwise_sq_dists_int8_pallas.
//    out[b, n] = max(xn[b] + yn[n] - 2 * sum_g s_g^2 * dot_g(qx_b, qy_n), 0)
//    with dot_g the int8 x int8 dot over dimension group g, accumulated in
//    int32 (never across groups: each group has its own scale), and the
//    f32 sum taken group by group in order; xn, yn are the store's
//    dequantized squared norms.
//    Bound: at the cascade kNN block (4096,128)x(65536,128) the f32 output
//    (1 GiB) dominates the bytes (~0.32 ms at 3.35 TB/s); the int8 MACs
//    are ~0.03 ms on the int8 tensor-core peak, so the output write bounds
//    it. Design: a CUDA-core tile like the f32 pairwise kernel — 128x128
//    outputs per 256-thread block, an 8x8 register tile per thread, codes
//    staged k-major in shared memory as 32-bit words (4 codes each) and
//    multiplied with __dp4a into int32 accumulators; after each group the
//    int32 sums are scaled into the f32 accumulators. Tensor-core
//    mma.sync s8 is later work.
//
// 2. repro_rowwise_sq_dists_int8 — replaces
//    repro/kernels/int8.py::rowwise_sq_dists_int8_pallas.
//    out[b, k] = sum_g s_g^2 * sum_{i in g} (c[b,k,i] - qx[b,i])^2, the
//    difference form, exact in int32 per group (<= 254^2 * 128 ~ 8.3e6).
//    Two entries share one kernel: the (B, K, d) candidate tensor the TPU
//    kernel takes (ids == nullptr), and a gather form that reads candidate
//    row ids[b, k] of the code table itself, so the (B, K, d) tensor the
//    JAX traversal gathers is never built; an id outside [0, N) (NO_NODE)
//    reads no row and gives +inf.
//    Bound: each candidate row is read once, so bytes (d x 1 per row).
//    Design: one warp per (query, candidate) pair; lanes stride each group
//    with 4-byte words (one coalesced 128-byte read per group at d = 128),
//    an int32 shuffle reduction per group, then the scaled f32 add.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kChunk = 128;              // dims staged per step (32 words)
constexpr int kWords = kChunk / 4;
constexpr int kThreads = 256;

// 16 codes of row r starting at dim k (never past the chunk end ce),
// zero outside the (nrows, d) matrix. vec16: d % 16 == 0, group_size %
// 16 == 0 and a 16-byte aligned base, so a 16-byte load never straddles.
__device__ __forceinline__ void load16(const int8_t* __restrict__ p, long long r,
                                       long long nrows, int k, int ce, int d,
                                       int vec16, int w[4]) {
  if (r < nrows && k < ce) {
    const int8_t* rowp = p + r * (long long)d;
    if (vec16) {
      const int4 t = __ldg(reinterpret_cast<const int4*>(rowp + k));
      w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
      return;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int kk = k + 4 * i + b;
        const uint32_t byte = kk < ce ? (uint8_t)__ldg(rowp + kk) : 0u;
        v |= byte << (8 * b);
      }
      w[i] = (int)v;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = 0;
}

__global__ void __launch_bounds__(kThreads)
pairwise_int8_kernel(const int8_t* __restrict__ qx, const int8_t* __restrict__ qy,
                     const float* __restrict__ scales,
                     const float* __restrict__ xn, const float* __restrict__ yn,
                     float* __restrict__ out, int B, int N, int d, int gs,
                     int vec16) {
  __shared__ __align__(16) int As[kWords][kBM];
  __shared__ __align__(16) int Bs[kWords][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long row0 = (long long)blockIdx.y * kBM;
  const long long col0 = (long long)blockIdx.x * kBN;
  // loader: 128 rows x 32 words per operand; a thread takes 16 words of
  // one row as four 16-byte pieces
  const int lr = tid / 2;
  const int lw = (tid % 2) * 16;

  float sum[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) sum[i][j] = 0.f;

  const int G = (d + gs - 1) / gs;
  for (int g = 0; g < G; ++g) {
    const int g0 = g * gs;
    const int ge = min(g0 + gs, d);
    int acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0;

    for (int c0 = g0; c0 < ge; c0 += kChunk) {
      const int ce = min(c0 + kChunk, ge);
#pragma unroll
      for (int piece = 0; piece < 4; ++piece) {
        const int w0 = lw + 4 * piece;
        int v[4];
        load16(qx, row0 + lr, B, c0 + 4 * w0, ce, d, vec16, v);
#pragma unroll
        for (int i = 0; i < 4; ++i) As[w0 + i][lr] = v[i];
        load16(qy, col0 + lr, N, c0 + 4 * w0, ce, d, vec16, v);
#pragma unroll
        for (int i = 0; i < 4; ++i) Bs[w0 + i][lr] = v[i];
      }
      __syncthreads();
      const int nw = (ce - c0 + 3) / 4;
      for (int w = 0; w < nw; ++w) {
        const int4 a0 = *reinterpret_cast<const int4*>(&As[w][ty * 4]);
        const int4 a1 = *reinterpret_cast<const int4*>(&As[w][64 + ty * 4]);
        const int4 b0 = *reinterpret_cast<const int4*>(&Bs[w][tx * 4]);
        const int4 b1 = *reinterpret_cast<const int4*>(&Bs[w][64 + tx * 4]);
        const int a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const int b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    const float s = __ldg(scales + g);
    const float s2 = s * s;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sum[i][j] = __fadd_rn(sum[i][j], __fmul_rn(s2, (float)acc[i][j]));
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (r >= B) continue;
    const float xr = __ldg(xn + r);
    float* orow = out + r * (long long)N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (c < N) orow[c] = fmaxf(xr + __ldg(yn + c) - 2.f * sum[i][j], 0.f);
    }
  }
}

// Squared difference of the 4 signed codes packed in a and b, summed.
__device__ __forceinline__ int sq_diff4(int a, int b) {
  int s = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = (int)(int8_t)(a >> (8 * i)) - (int)(int8_t)(b >> (8 * i));
    s += t * t;
  }
  return s;
}

__device__ __forceinline__ int warp_isum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// cands: the (B, K, d) code tensor when ids == nullptr, else the (N, d)
// code table read at ids[pair]. vec4: d % 4 == 0, gs % 4 == 0 and 4-byte
// aligned bases, so words never straddle a group.
__global__ void __launch_bounds__(kThreads)
rowwise_int8_kernel(const int8_t* __restrict__ qx, const int8_t* __restrict__ cands,
                    const int* __restrict__ ids, const float* __restrict__ scales,
                    float* __restrict__ out, long long n_pairs, int K, int d,
                    int gs, long long N, int vec4) {
  const long long pair = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (pair >= n_pairs) return;  // uniform across the warp
  const int8_t* c;
  if (ids != nullptr) {
    const int id = __ldg(ids + pair);
    if (id < 0 || (long long)id >= N) {
      if (lane == 0) out[pair] = INFINITY;
      return;
    }
    c = cands + (long long)id * d;
  } else {
    c = cands + pair * (long long)d;
  }
  const int8_t* q = qx + (pair / K) * (long long)d;
  float sum = 0.f;
  const int G = (d + gs - 1) / gs;
  for (int g = 0; g < G; ++g) {
    const int g0 = g * gs;
    const int ge = min(g0 + gs, d);
    int acc = 0;
    if (vec4) {
      for (int k = g0 + 4 * lane; k < ge; k += 128)
        acc += sq_diff4(__ldg(reinterpret_cast<const int*>(c + k)),
                        __ldg(reinterpret_cast<const int*>(q + k)));
    } else {
      for (int k = g0 + lane; k < ge; k += 32) {
        const int t = (int)__ldg(c + k) - (int)__ldg(q + k);
        acc += t * t;
      }
    }
    acc = warp_isum(acc);
    const float s = __ldg(scales + g);
    sum = __fadd_rn(sum, __fmul_rn(s * s, (float)acc));
  }
  if (lane == 0) out[pair] = sum;
}

}  // namespace

extern "C" int repro_pairwise_sq_dists_int8(const int8_t* qx, const int8_t* qy,
                                            const float* scales, const float* xn,
                                            const float* yn, float* out, int B,
                                            int N, int d, int gs, int vec16,
                                            void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  pairwise_int8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      qx, qy, scales, xn, yn, out, B, N, d, gs, vec16);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_rowwise_sq_dists_int8(const int8_t* qx, const int8_t* cands,
                                           const int* ids, const float* scales,
                                           float* out, long long n_pairs, int K,
                                           int d, int gs, long long N, int vec4,
                                           void* stream) {
  const long long blocks = (n_pairs + kThreads / 32 - 1) / (kThreads / 32);
  rowwise_int8_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      qx, cands, ids, scales, out, n_pairs, K, d, gs, N, vec4);
  return static_cast<int>(cudaGetLastError());
}
