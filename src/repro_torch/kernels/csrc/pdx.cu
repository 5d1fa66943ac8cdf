// Hand-written Hopper (sm_90a) kernels for PDX (dimension-partitioned)
// squared-L2 distances with certified mid-vector early exit, over PdxStore
// rows (repro_torch/quant/pdx.py: dimensions permuted by descending
// variance, padded to S slabs of `slab` dimensions, one int8 scale per
// slab).
//
// Both kernels accumulate a lane's distance slab by slab. With early exit a
// lane is live at slab k when it was live at every earlier slab and
//     acc + tail_k <= th,
// tail_k = max((sqrt(xtail_k) - sqrt(ytail_k))^2 - guard*(xn + yn)
//              - guard_abs, 0)
// the certified bound on the remaining dimensions (kernels/ref.py:
// deflate_tail). A retired lane ends at +inf and reports the slabs it
// scanned; a survivor holds the slab-ordered f32 sum. The sum is one code
// path for early exit on and off (one template, explicit __fadd_rn /
// __fmul_rn so nvcc contracts nothing into an FMA differently), and the
// retirement test never writes it, so survivors are bit-identical on and
// off. The operation order is the plain version's (kernels/ref.py).
//
// Built by kernels/_build.py with nvcc into the port's shared library with
// a plain C interface and bound with ctypes. Every entry point launches on
// the stream it is given, allocates nothing, and returns cudaGetLastError().
//
// 1. repro_pairwise_sq_dists_pdx — replaces the Pallas kernel
//    repro/kernels/pdx.py::pairwise_sq_dists_pdx_pallas.
//    Slab k adds max(xslab_k + yslab_k - 2 * s_k^2 * dot_k, 0), dot_k the
//    int8 x int8 dot of the slab in int32; th = (theta + xe + ye)^2 +
//    mguard * (xn + yn), so retirement certifies that the lane's lower bound
//    on the true distance exceeds theta^2.
//    Bound: at the pdx8 NLJ's block (512 queries x 1M rows) the two outputs
//    (f32 distance and int32 slab count, 4 GiB) are the bytes; the int8 MACs
//    are far below the int8 peak, so the output write bounds it.
//    Design: the int8 pairwise kernel's tile (csrc/int8.cu) with a slab as
//    the dimension group — 128 x 128 lanes per 256-thread block, 8 x 8 per
//    thread, codes staged k-major in shared memory and multiplied with
//    __dp4a. Per thread, a 64-bit mask holds which lanes are live; a retired
//    lane keeps its slab count in its (no longer needed) accumulator. A
//    block whose lanes have all retired skips the slab's loads and dots
//    (__syncthreads_or), as the TPU kernel skips a block with no live lane.
//
// 2. repro_pdx_gather_sq_dists — replaces
//    repro/kernels/pdx.py::pdx_gather_sq_dists_pallas.
//    Reads candidate row ids[b, k] of the f32 PDX table by id; slab k adds
//    sum (v - x)^2 over the slab; th = th2 (theta^2). An id outside [0, N)
//    (NO_NODE) reads no row and gives (+inf, 0).
//    Bound: bytes — each valid candidate's scanned slabs are read once.
//    Design: one warp per (query, candidate) pair; lanes stride the slab
//    with 16-byte loads, and an XOR-butterfly shuffle sums it (every lane
//    ends with the same value, so the retirement test is warp-uniform and a
//    retired lane reads no further slab).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kChunk = 128;              // dims staged per step (32 words)
constexpr int kWords = kChunk / 4;
constexpr int kThreads = 256;

// 16 codes of row r starting at dim k (never past ce), zero outside the
// (nrows, d) matrix; vec16: 16-byte aligned rows and slabs.
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

// the deflated tail bound and the threshold test, in the plain version's
// operation order
__device__ __forceinline__ float tail_bound(float sx, float sy, float energy,
                                            float guard, float guard_abs) {
  const float dd = __fsub_rn(sx, sy);
  const float rt = __fmul_rn(dd, dd);
  return fmaxf(__fsub_rn(__fsub_rn(rt, __fmul_rn(guard, energy)), guard_abs),
               0.f);
}

__device__ __forceinline__ int row_of(int i, int ty) {
  return i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4);
}

template <bool EE>
__global__ void __launch_bounds__(kThreads)
pdx_pairwise_kernel(const int8_t* __restrict__ qx, const int8_t* __restrict__ qy,
                    const float* __restrict__ scales,
                    const float* __restrict__ xslab, const float* __restrict__ yslab,
                    const float* __restrict__ xtail, const float* __restrict__ ytail,
                    const float* __restrict__ xn, const float* __restrict__ yn,
                    const float* __restrict__ xe, const float* __restrict__ ye,
                    float* __restrict__ out, int* __restrict__ nscan, int B,
                    int N, int S, int slab, float theta, float guard,
                    float guard_abs, float mguard, int vec16) {
  __shared__ __align__(16) int As[kWords][kBM];
  __shared__ __align__(16) int Bs[kWords][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long row0 = (long long)blockIdx.y * kBM;
  const long long col0 = (long long)blockIdx.x * kBN;
  const int lr = tid / 2;
  const int lw = (tid % 2) * 16;
  const int d = S * slab;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  unsigned long long alive = ~0ull;        // bit 8*i + j: lane (i, j) live

  for (int k = 0; k < S; ++k) {
    unsigned long long live = alive;
    if (EE) {
      // retirement test at the start of slab k (rows/cols past the edge
      // read row 0's tables: their lanes are never written)
      float sx[8], sy[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long r = row0 + row_of(i, ty);
        sx[i] = sqrtf(__ldg(xtail + (r < B ? r : 0) * S + k));
        const long long c = col0 + row_of(i, tx);
        sy[i] = sqrtf(__ldg(ytail + (c < N ? c : 0) * S + k));
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long r = row0 + row_of(i, ty);
        const long long rr = r < B ? r : 0;
        const float xni = __ldg(xn + rr), xei = __ldg(xe + rr);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int bit = 8 * i + j;
          if (!((alive >> bit) & 1ull)) continue;
          const long long c = col0 + row_of(j, tx);
          const long long cc = c < N ? c : 0;
          const float energy = __fadd_rn(xni, __ldg(yn + cc));
          const float t = __fadd_rn(__fadd_rn(theta, xei), __ldg(ye + cc));
          const float th = __fadd_rn(__fmul_rn(t, t), __fmul_rn(mguard, energy));
          const float tl = tail_bound(sx[i], sy[j], energy, guard, guard_abs);
          if (!(__fadd_rn(acc[i][j], tl) <= th)) {
            live &= ~(1ull << bit);
            acc[i][j] = __int_as_float(k);     // slabs scanned
          }
        }
      }
      alive = live;
      if (!__syncthreads_or(live != 0ull)) continue;   // whole block retired
    }

    // int32 dots of slab k, chunk by chunk
    int dot[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dot[i][j] = 0;
    const int g0 = k * slab;
    const int ge = g0 + slab;
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
          for (int j = 0; j < 8; ++j) dot[i][j] = __dp4a(a[i], b[j], dot[i][j]);
      }
      __syncthreads();
    }

    // contributions, added only to live lanes
    const float s = __ldg(scales + k);
    const float t2 = __fmul_rn(2.f, __fmul_rn(s, s));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long r = row0 + row_of(i, ty);
      const float xs = __ldg(xslab + (r < B ? r : 0) * S + k);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long c = col0 + row_of(j, tx);
        const float ys = __ldg(yslab + (c < N ? c : 0) * S + k);
        const float cv = fmaxf(
            __fsub_rn(__fadd_rn(xs, ys), __fmul_rn(t2, (float)dot[i][j])), 0.f);
        if (!EE || ((live >> (8 * i + j)) & 1ull))
          acc[i][j] = __fadd_rn(acc[i][j], cv);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = row0 + row_of(i, ty);
    if (r >= B) continue;
    float* orow = out + r * (long long)N;
    int* nrow = nscan + r * (long long)N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long c = col0 + row_of(j, tx);
      if (c >= N) continue;
      const bool ok = !EE || ((alive >> (8 * i + j)) & 1ull);
      orow[c] = ok ? acc[i][j] : INFINITY;
      nrow[c] = ok ? S : __float_as_int(acc[i][j]);
    }
  }
}

__device__ __forceinline__ float warp_fsum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// vec4: slab % 4 == 0 and 16-byte aligned bases
template <bool EE>
__global__ void __launch_bounds__(kThreads)
pdx_gather_kernel(const float* __restrict__ vp, const float* __restrict__ vtail,
                  const float* __restrict__ vnorm, const float* __restrict__ xp,
                  const float* __restrict__ xtail, const float* __restrict__ xn,
                  const int* __restrict__ ids, float* __restrict__ out,
                  int* __restrict__ nscan, long long n_pairs, int K, int S,
                  int slab, long long N, float th2, float guard,
                  float guard_abs, int vec4) {
  const long long pair = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (pair >= n_pairs) return;  // uniform across the warp
  const int id = __ldg(ids + pair);
  if (id < 0 || (long long)id >= N) {
    if (lane == 0) {
      out[pair] = INFINITY;
      nscan[pair] = 0;
    }
    return;
  }
  const long long b = pair / K;
  const long long d = (long long)S * slab;
  const float* v = vp + (long long)id * d;
  const float* x = xp + b * d;
  const float energy = __fadd_rn(__ldg(xn + b), __ldg(vnorm + id));
  float acc = 0.f;
  int k = 0;
  for (; k < S; ++k) {
    if (EE) {
      const float tl = tail_bound(sqrtf(__ldg(xtail + b * S + k)),
                                  sqrtf(__ldg(vtail + (long long)id * S + k)),
                                  energy, guard, guard_abs);
      if (!(__fadd_rn(acc, tl) <= th2)) break;          // warp-uniform
    }
    const int g0 = k * slab;
    float s = 0.f;
    if (vec4) {
      for (int i = g0 + 4 * lane; i < g0 + slab; i += 128) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(v + i));
        const float4 q = __ldg(reinterpret_cast<const float4*>(x + i));
        float t = __fsub_rn(a.x, q.x);
        s = __fadd_rn(s, __fmul_rn(t, t));
        t = __fsub_rn(a.y, q.y);
        s = __fadd_rn(s, __fmul_rn(t, t));
        t = __fsub_rn(a.z, q.z);
        s = __fadd_rn(s, __fmul_rn(t, t));
        t = __fsub_rn(a.w, q.w);
        s = __fadd_rn(s, __fmul_rn(t, t));
      }
    } else {
      for (int i = g0 + lane; i < g0 + slab; i += 32) {
        const float t = __fsub_rn(__ldg(v + i), __ldg(x + i));
        s = __fadd_rn(s, __fmul_rn(t, t));
      }
    }
    acc = __fadd_rn(acc, warp_fsum(s));
  }
  if (lane == 0) {
    out[pair] = k == S ? acc : INFINITY;
    nscan[pair] = k;
  }
}

}  // namespace

extern "C" int repro_pairwise_sq_dists_pdx(
    const int8_t* qx, const int8_t* qy, const float* scales, const float* xslab,
    const float* yslab, const float* xtail, const float* ytail, const float* xn,
    const float* yn, const float* xe, const float* ye, float* out, int* nscan,
    int B, int N, int S, int slab, float theta, float guard, float guard_abs,
    float mguard, int early_exit, int vec16, void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (early_exit)
    pdx_pairwise_kernel<true><<<grid, kThreads, 0, st>>>(
        qx, qy, scales, xslab, yslab, xtail, ytail, xn, yn, xe, ye, out, nscan,
        B, N, S, slab, theta, guard, guard_abs, mguard, vec16);
  else
    pdx_pairwise_kernel<false><<<grid, kThreads, 0, st>>>(
        qx, qy, scales, xslab, yslab, xtail, ytail, xn, yn, xe, ye, out, nscan,
        B, N, S, slab, theta, guard, guard_abs, mguard, vec16);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_pdx_gather_sq_dists(
    const float* vp, const float* vtail, const float* vnorm, const float* xp,
    const float* xtail, const float* xn, const int* ids, float* out, int* nscan,
    long long n_pairs, int K, int S, int slab, long long N, float th2,
    float guard, float guard_abs, int early_exit, int vec4, void* stream) {
  const long long blocks = (n_pairs + kThreads / 32 - 1) / (kThreads / 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (early_exit)
    pdx_gather_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        vp, vtail, vnorm, xp, xtail, xn, ids, out, nscan, n_pairs, K, S, slab,
        N, th2, guard, guard_abs, vec4);
  else
    pdx_gather_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        vp, vtail, vnorm, xp, xtail, xn, ids, out, nscan, n_pairs, K, S, slab,
        N, th2, guard, guard_abs, vec4);
  return static_cast<int>(cudaGetLastError());
}
