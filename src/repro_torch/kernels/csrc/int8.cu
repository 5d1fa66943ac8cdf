// Hand-written Hopper (sm_90a) kernels for quantized (int8) squared-L2
// distances over QuantStore codes (per-dimension-group scaled int8, see
// repro_torch/quant/store.py), and the certified bounds of the int8 tier.
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
//    dequantized squared norms. The int32 dots are exact in any order, so
//    with these f32 steps the output is bit for bit the CUDA-core kernel's
//    it replaced (and kernels/ref.py::pairwise_sq_dists_int8_exact's).
// 1'. repro_pairwise_bounds_int8 — the same tile with the int8 tier's
//    certified-bound chain (quant/cascade.py Int8Tier.pairwise_bounds) in
//    its epilogue: guard = f32(MATMUL_GUARD)·(xn + yn), slack = ex + ey,
//    lb = max(√max(d̂ − guard, 0) − slack, 0)², ub = (√max(d̂ + guard, 0) +
//    slack)² (+inf and NaN passed through as torch's where/clamp pass
//    them), every step rounded on its own (__fadd_rn & co., no fma
//    contraction), so (lb, ub) equal torch's composition bit for bit. It
//    is what JAX's jit fuses behind the TPU kernel; eager torch ran ~20
//    passes over each (B, N) f32 block instead.
//    Bound: at the cascade kNN block (4096,128)x(65536,128) the f32 output
//    (1 GiB, 2 GiB for the bounds) dominates the bytes (0.32 / 0.64 ms at
//    3.35 TB/s); the int8 MACs are ~0.035 ms on the int8 tensor-core peak,
//    so the output writes bound both. Design: each 256-thread block keeps
//    128 query rows resident in shared memory (the whole padded depth) and
//    walks a strip of 64-row data tiles through a 3-stage cp.async ring of
//    128-byte depth chunks, so one tile's loads overlap the previous
//    tile's MMAs and stores. 8 warps of 32x32 outputs run
//    mma.sync.m16n8k32 s8·s8→s32 on fragments read with ldmatrix (both
//    operands K-contiguous rows, padded to a 16-byte-odd stride:
//    conflict-free). Each group's depth is zero-padded to a multiple of 32
//    in shared memory, so no k32 step straddles two groups; at a group's
//    end the int32 tile is scaled into the f32 sums. The epilogue writes
//    each C fragment's two columns as one 8-byte streaming store, so each
//    quad of lanes fills one 32-byte sector (quad shuffles to 16-byte
//    stores timed 6-11% slower on an H100: more issue slots than the
//    wider store saves). Where the query tile does not fit (d above
//    ~1,300) its chunks stream through the ring beside the data's.
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

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// 1, 1'. pairwise on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kBM = 128;             // query rows per block, resident
constexpr int kBN = 64;              // data rows per tile
constexpr int kKC = 128;             // padded depth bytes per ring stage
constexpr int kPad = 16;             // row padding: 16·odd-byte strides
constexpr int kStages = 3;           // ring depth (2 and 4 timed the same)
constexpr int kSmemMax = 232448;     // the H100's 227 KiB a block

// The padded depth layout of a row in shared memory: groups 0..G-2 take
// gsp bytes each (gs rounded up to 32), the last one its own length
// rounded up to 32; Kp is the whole padded depth.
struct Geo {
  int d, gs, G, gsp, Kp;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One copy of w bytes into shared memory, zero-filled when !ok (the
// source is then not read).
__device__ __forceinline__ void cp_async(void* dst, const void* src, int w,
                                         bool ok) {
  const unsigned d = smem_addr(dst);
  const int n = ok ? w : 0;
  if (w == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n));
  else if (w == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Rows [row0, row0 + R) of a (nrows, d) code matrix, padded depth
// [kp0, kp0 + len) (len a multiple of 32), into shared memory at dst with
// the given row stride; rows past nrows and group padding read zeros.
// vw = 16, 8, 4: cp.async pieces of vw bytes (d, gs and the base are
// vw-aligned, so a piece never straddles a group's end); 0: byte loads.
__device__ __forceinline__ void load_rows(int8_t* dst, int stride,
                                          const int8_t* __restrict__ src,
                                          long long row0, long long nrows,
                                          int R, int kp0, int len,
                                          const Geo& g, int vw) {
  if (vw == 16 && len == kKC && g.G == 1) {   // the usual case, no division
    constexpr int upr = kKC / 16;
    for (int u = threadIdx.x; u < R * upr; u += kThreads) {
      const int r = u / upr;
      const int o = kp0 + (u % upr) * 16;
      const long long row = row0 + r;
      const bool ok = row < nrows && o < g.d;
      cp_async(dst + r * stride + (o - kp0), ok ? src + row * g.d + o : src,
               16, ok);
    }
    return;
  }
  const int U = vw ? vw : 4;
  const int upr = len / U;
  const int total = R * upr;
  for (int u = threadIdx.x; u < total; u += kThreads) {
    const int r = u / upr;
    const int kp = kp0 + (u - r * upr) * U;
    const int grp = min(kp / g.gsp, g.G - 1);
    const int o = kp - grp * g.gsp;
    const int gl = grp < g.G - 1 ? g.gs : g.d - (g.G - 1) * g.gs;
    const long long row = row0 + r;
    int8_t* s = dst + r * stride + (kp - kp0);
    const int8_t* p = src + row * g.d + grp * g.gs + o;
    if (vw) {
      const bool ok = row < nrows && o < gl;
      cp_async(s, ok ? p : src, vw, ok);
    } else {
      uint32_t w = 0;
      if (row < nrows) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (o + b < gl) w |= (uint32_t)(uint8_t)__ldg(p + b) << (8 * b);
      }
      *reinterpret_cast<uint32_t*>(s) = w;
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const int8_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// torch.clamp_min(v, 0): NaN passes through
__device__ __forceinline__ float clamp0(float v) {
  return v != v ? v : fmaxf(v, 0.f);
}

// A C fragment's two columns of row r as one 8-byte streaming store: the
// quad of lanes that holds a row of an n8 tile writes one whole 32-byte
// sector (evict-first: the output is not read back from L2). Scalar
// stores only where N is odd or at the ragged edge.
__device__ __forceinline__ void store_pair(float* __restrict__ out, long long r,
                                           long long c, int B, int N,
                                           int vec_out, float a, float b) {
  if (r >= B) return;
  float* o = out + r * (long long)N + c;
  if (vec_out && c + 1 < N) {
    __stcs(reinterpret_cast<float2*>(o), make_float2(a, b));
  } else {
    if (c < N) o[0] = a;
    if (c + 1 < N) o[1] = b;
  }
}

struct PairArgs {
  const int8_t* qx;
  const int8_t* qy;
  const float* scales;
  const float* xn;
  const float* yn;
  const float* ex;         // bounds only: per-row L2 quantization errors
  const float* ey;
  float* out0;             // d̂, or lb
  float* out1;             // ub (bounds only)
  int B, N;
  Geo g;
  int vw, tpb, vec_out;
  float guard;             // f32(MATMUL_GUARD) (bounds only)
};

// XRES: the query tile stays resident at its whole padded depth (else
// its chunks stream through the ring too). BOUNDS: write (lb, ub).
template <bool XRES, bool BOUNDS>
__global__ void __launch_bounds__(kThreads, 2)
pairwise_int8_kernel(const PairArgs a) {
  extern __shared__ __align__(16) int8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;   // 4 x 2 warps of 32 x 32
  const int grp = lane >> 2, tig = lane & 3;
  const long long row0 = (long long)blockIdx.y * kBM;
  const int t0 = blockIdx.x * a.tpb;
  const int ntile = min(a.tpb, (a.N + kBN - 1) / kBN - t0);
  if (ntile <= 0) return;                    // uniform over the block
  const int Kp = a.g.Kp;
  const int nch = (Kp + kKC - 1) / kKC;
  const int nwork = ntile * nch;             // (tile, depth chunk) steps
  const int xstride = XRES ? Kp + kPad : kKC + kPad;
  constexpr int ystride = kKC + kPad;
  int8_t* xs = smem;
  int8_t* ys = smem + (XRES ? kBM : kStages * kBM) * xstride;

  auto issue = [&](int w) {
    const int s = w % kStages;
    const int t = t0 + w / nch, c = w % nch;
    const int len = min(kKC, Kp - c * kKC);
    load_rows(ys + s * kBN * ystride, ystride, a.qy, (long long)t * kBN, a.N,
              kBN, c * kKC, len, a.g, a.vw);
    if (!XRES)
      load_rows(xs + s * kBM * xstride, xstride, a.qx, row0, a.B, kBM,
                c * kKC, len, a.g, a.vw);
  };

  if (XRES) load_rows(xs, xstride, a.qx, row0, a.B, kBM, 0, Kp, a.g, a.vw);
  cp_async_commit();
#pragma unroll
  for (int w = 0; w < kStages - 1; ++w) {
    if (w < nwork) issue(w);
    cp_async_commit();
  }

  int acc[2][4][4];
  float sum[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][ni][e] = 0;
        sum[mi][ni][e] = 0.f;
      }
  const int spg = a.g.gsp / 32;              // k32 steps of a full group
  const int nsteps = Kp / 32;
  // the thread's four rows (wm·32 + mi·16 + grp + 8·h) are the block's
  // for every tile: their norms (and errors) are read once
  float xr[2][2], xe[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = row0 + wm * 32 + mi * 16 + grp + 8 * h;
      const bool in = r < a.B;
      xr[mi][h] = in ? __ldg(a.xn + r) : 0.f;
      xe[mi][h] = (BOUNDS && in) ? __ldg(a.ex + r) : 0.f;
    }

  for (int w = 0; w < nwork; ++w) {
    cp_async_wait<kStages - 2>();            // step w's chunk has landed
    __syncthreads();
    // the stage refilled here was read in step w - 1, which every thread
    // finished before the barrier above
    if (w + kStages - 1 < nwork) issue(w + kStages - 1);
    cp_async_commit();
    const int s = w % kStages;
    const int t = t0 + w / nch, c = w % nch;
    const int8_t* xb = XRES ? xs + c * kKC : xs + s * kBM * xstride;
    const int8_t* yb = ys + s * kBN * ystride;
    const int steps = min(kKC, Kp - c * kKC) / 32;
    // the tile's column norms (and errors), in flight during the MMAs:
    // C fragment (mi, ni, e) is row wm·32 + mi·16 + grp + 8·(e >> 1),
    // column wn·32 + ni·8 + 2·tig + (e & 1)
    const long long colw = (long long)t * kBN + wn * 32;
    float ync[4][2], yec[4][2];
    if (c == nch - 1) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long col = colw + ni * 8 + 2 * tig + e;
          const bool in = col < a.N;
          ync[ni][e] = in ? __ldg(a.yn + col) : 0.f;
          yec[ni][e] = (BOUNDS && in) ? __ldg(a.ey + col) : 0.f;
        }
    }
#pragma unroll
    for (int st = 0; st < kKC / 32; ++st) {
      if (st >= steps) break;
      const int kk = st * 32;
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(af[mi], xb + (wm * 32 + mi * 16 + (lane & 15)) * xstride + kk +
                            (lane >> 4) * 16);
#pragma unroll
      for (int p = 0; p < 2; ++p)
        ldsm_x4(bf[p], yb + (wn * 32 + p * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) *
                                ystride + kk + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2],
                 bf[ni >> 1][(ni & 1) * 2 + 1]);
      const int ks = c * (kKC / 32) + st;
      if ((ks + 1) % spg == 0 || ks + 1 == nsteps) {   // a group ends here
        const float sc = __ldg(a.scales + min(ks / spg, a.g.G - 1));
        const float s2 = __fmul_rn(sc, sc);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sum[mi][ni][e] = __fadd_rn(sum[mi][ni][e],
                                         __fmul_rn(s2, (float)acc[mi][ni][e]));
              acc[mi][ni][e] = 0;
            }
      }
    }
    if (c != nch - 1) continue;

    // epilogue of tile t
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = row0 + wm * 32 + mi * 16 + grp + 8 * h;
        float v0[4][2], v1[4][2];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float nsum = __fadd_rn(xr[mi][h], ync[ni][e]);
            const float dh = fmaxf(
                __fsub_rn(nsum, __fmul_rn(2.f, sum[mi][ni][2 * h + e])), 0.f);
            if (BOUNDS) {
              const float guard = __fmul_rn(a.guard, nsum);
              const float slack = __fadd_rn(xe[mi][h], yec[ni][e]);
              const float lo = clamp0(__fsub_rn(dh, guard));
              const float l = clamp0(__fsub_rn(__fsqrt_rn(clamp0(lo)), slack));
              v0[ni][e] = isfinite(lo) ? __fmul_rn(l, l) : lo;
              const float hi = __fadd_rn(dh, guard);
              const float u = __fadd_rn(__fsqrt_rn(clamp0(hi)), slack);
              v1[ni][e] = isfinite(hi) ? __fmul_rn(u, u) : hi;
            } else {
              v0[ni][e] = dh;
            }
          }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const long long col = colw + ni * 8 + 2 * tig;
          store_pair(a.out0, r, col, a.B, a.N, a.vec_out, v0[ni][0], v0[ni][1]);
          if (BOUNDS)
            store_pair(a.out1, r, col, a.B, a.N, a.vec_out, v1[ni][0], v1[ni][1]);
        }
      }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[mi][ni][e] = 0.f;
  }
  cp_async_wait<0>();
}

template <bool XRES, bool BOUNDS>
int launch_pairwise(const PairArgs& a, dim3 grid, int smem,
                    cudaStream_t stream) {
  auto kernel = pairwise_int8_kernel<XRES, BOUNDS>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, int w) {
  return reinterpret_cast<uintptr_t>(p) % w == 0;
}

int pairwise_int8(PairArgs a, int d, int gs, bool bounds, void* stream) {
  Geo& g = a.g;
  g.d = d;
  g.gs = gs;
  g.G = (d + gs - 1) / gs;
  g.gsp = (gs + 31) / 32 * 32;
  g.Kp = (g.G - 1) * g.gsp + (d - (g.G - 1) * gs + 31) / 32 * 32;
  a.vw = 0;
  for (int w = 16; w >= 4; w /= 2)
    if (d % w == 0 && gs % w == 0 && aligned(a.qx, w) && aligned(a.qy, w)) {
      a.vw = w;
      break;
    }
  // 8-byte stores need every output row 8-byte aligned
  a.vec_out = a.N % 2 == 0 && aligned(a.out0, 8) &&
              (!bounds || aligned(a.out1, 8));
  const int ring = kStages * kBN * (kKC + kPad);
  const int xres = kBM * (g.Kp + kPad) + ring;
  const bool resident = xres <= kSmemMax;
  const int smem = resident ? xres : kStages * kBM * (kKC + kPad) + ring;
  // a strip of data tiles per block: about eight blocks an SM in all
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int ntm = (a.B + kBM - 1) / kBM;
  const int ntn = (a.N + kBN - 1) / kBN;
  const int strips = max(1, min(ntn, (8 * sms + ntm - 1) / ntm));
  a.tpb = (ntn + strips - 1) / strips;
  const dim3 grid((ntn + a.tpb - 1) / a.tpb, ntm);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bounds)
    return resident ? launch_pairwise<true, true>(a, grid, smem, st)
                    : launch_pairwise<false, true>(a, grid, smem, st);
  return resident ? launch_pairwise<true, false>(a, grid, smem, st)
                  : launch_pairwise<false, false>(a, grid, smem, st);
}

// ---------------------------------------------------------------------------
// 2. rowwise / gather (difference form)
// ---------------------------------------------------------------------------

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
                                            int N, int d, int gs, void* stream) {
  PairArgs a{};
  a.qx = qx; a.qy = qy; a.scales = scales; a.xn = xn; a.yn = yn;
  a.out0 = out; a.B = B; a.N = N;
  return pairwise_int8(a, d, gs, false, stream);
}

extern "C" int repro_pairwise_bounds_int8(const int8_t* qx, const int8_t* qy,
                                          const float* scales, const float* xn,
                                          const float* yn, const float* ex,
                                          const float* ey, float* lb, float* ub,
                                          int B, int N, int d, int gs,
                                          float guard, void* stream) {
  PairArgs a{};
  a.qx = qx; a.qy = qy; a.scales = scales; a.xn = xn; a.yn = yn;
  a.ex = ex; a.ey = ey; a.out0 = lb; a.out1 = ub; a.B = B; a.N = N;
  a.guard = guard;
  return pairwise_int8(a, d, gs, true, stream);
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
