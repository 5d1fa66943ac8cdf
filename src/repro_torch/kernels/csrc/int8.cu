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
//    so the output writes bound both. Design (the tile of int8_tile.cuh,
//    shared with pdx.cu's pairwise kernels): each 256-thread block keeps
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
//    out[p] = sum_g s_g^2 * sum_{i in g} (c[p,i] - qx[q(p),i])^2, the
//    difference form, exact in int32 per group (<= 255^2 * gs), the f32
//    sum taken group by group in order. One kernel, three entries: the
//    (B, K, d) candidate tensor the TPU kernel takes (ids == nullptr), the
//    gather form that reads row ids[p] of the (N, d) code table (query row
//    q(p) = p / K), and its pair list (q(p) = qi[p], called with the
//    bounds of 2' only: the NLJ's escalation reads the pairs' query rows in
//    place, no copy). An id or query row out of range (NO_NODE) reads no
//    row and gives +inf.
// 2'. With err/qerr (bounds): the int8 tier's certified bounds fused into
//    the epilogue (quant/cascade.py Int8Tier.gather_bounds, PdxTier.
//    gather_bounds, pair_refine): slack = qerr[q] + err[id], lb =
//    max(√d̂ − slack, 0)², ub = (√d̂ + slack)², each step rounded on its
//    own (__fsqrt_rn, __f*_rn) as torch's quant_lower_bound and
//    quant_upper_bound take them, so (lb, ub) equal the composition over
//    d̂ bit for bit; +inf for both at NO_NODE, without reading err. The
//    bounds so cost the caller no pass of its own over the pairs.
//    Bound: bytes (d per candidate row, plus ids, errors and outputs). At
//    the traversal's shape (256 x 128 ids, half NO_NODE) that is ~0.7 us:
//    the id -> row latency sets the time, so the design puts many rows in
//    flight. A warp owns a run of 32 pairs: each lane reads one id (one
//    coalesced load, with its query row and, for the bounds, both errors),
//    a ballot drops NO_NODE before any row read, and each 8-lane quarter
//    takes 8 of the rows, a lane loading its W-byte chunk (16 bytes at
//    d = 128: a row is 8 lanes) of all 8 before summing any; the query
//    chunk is read once while the rows share the query. A chunk's
//    squared differences are __vabsdiffs4 + __dp4a per word (exact).
//    Per dimension group the quarter's 8 lanes add their 8 rows' sums in
//    one butterfly that leaves lane j with row j's total (7 shuffles for
//    8 rows), and that lane adds s_g^2 * sum into its row's f32 sum, so
//    lane j of the warp owns pair j from id load to store (coalesced).
//    Groups not aligned to the chunk passes (PDX slabs) are summed with
//    the lanes of other groups masked out, in group order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "int8_tile.cuh"

namespace {

using namespace repro_i8;

// ---------------------------------------------------------------------------
// 1, 1'. pairwise on the tensor cores (the tile of int8_tile.cuh)
// ---------------------------------------------------------------------------

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
      warp_mma_k32(acc, xb, xstride, yb, ystride, wm, wn, lane, st * 32);
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
              bound_chain(dh, nsum, __fadd_rn(xe[mi][h], yec[ni][e]),
                          a.guard, v0[ni][e], v1[ni][e]);
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

int pairwise_int8(PairArgs a, int d, int gs, bool bounds, void* stream) {
  Geo& g = a.g;
  g = make_geo(d, gs);
  a.vw = piece_width(d, gs, a.qx, a.qy);
  // 8-byte stores need every output row 8-byte aligned
  a.vec_out = a.N % 2 == 0 && aligned(a.out0, 8) &&
              (!bounds || aligned(a.out1, 8));
  const int ring = kStages * kBN * (kKC + kPad);
  const int xres = kBM * (g.Kp + kPad) + ring;
  const bool resident = xres <= kSmemMax;
  const int smem = resident ? xres : kStages * kBM * (kKC + kPad) + ring;
  dim3 grid;
  a.tpb = strip_grid(a.B, a.N, &grid);
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

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGatherWarps = 4;      // warps a block
constexpr int kRows = 8;             // rows an 8-lane quarter holds
constexpr int kRun8 = 32;            // pairs a warp owns

struct GatherArgs {
  const int8_t* qx;        // (B, d) query codes
  const int8_t* cands;     // (B, K, d) codes (ids == nullptr), else (N, d)
  const int* ids;          // the pairs' row ids, or nullptr
  const int* qi;           // the pairs' query rows (pair list), or nullptr
  const float* scales;     // (G,)
  const float* err;        // bounds: (N,) per-row L2 quantization errors
  const float* qerr;       // bounds: (B,) the queries'
  float* out0;             // d̂, or lb
  float* out1;             // ub (bounds only)
  long long n_pairs, N;
  int K, d, gs, B;
};

// W bytes of codes (W = 16, 8, 4 or 1) as words; the bytes past W are 0
template <int W>
__device__ __forceinline__ uint4 load_chunk(const int8_t* p) {
  if constexpr (W == 16) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else if constexpr (W == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    return make_uint4(v.x, v.y, 0u, 0u);
  } else if constexpr (W == 4) {
    return make_uint4(__ldg(reinterpret_cast<const unsigned*>(p)), 0u, 0u, 0u);
  } else {
    return make_uint4(static_cast<uint8_t>(__ldg(p)), 0u, 0u, 0u);
  }
}

// Sum of the squared differences of the signed codes in a and b: per word
// |a_i - b_i| (<= 255) by __vabsdiffs4, squared and added by __dp4a; exact
template <int W>
__device__ __forceinline__ unsigned sq_diff(uint4 a, uint4 b) {
  unsigned t = __vabsdiffs4(a.x, b.x);
  unsigned s = __dp4a(t, t, 0u);
  if constexpr (W == 16 || W == 8) {
    t = __vabsdiffs4(a.y, b.y);
    s = __dp4a(t, t, s);
  }
  if constexpr (W == 16) {
    t = __vabsdiffs4(a.z, b.z);
    s = __dp4a(t, t, s);
    t = __vabsdiffs4(a.w, b.w);
    s = __dp4a(t, t, s);
  }
  return s;
}

// The 8 lanes of a quarter add their 8 sums: at the offsets 4, 2, 1 a lane
// keeps half of its sums and trades the other half; lane j ends with sum
// j's total (7 shuffles). Integer sums: exact in any order.
__device__ __forceinline__ unsigned quarter_sum8(unsigned (&v)[kRows],
                                                 int lane) {
#pragma unroll
  for (int h = kRows / 2; h >= 1; h >>= 1) {
    const bool up = lane & h;
#pragma unroll
    for (int k = 0; k < h; ++k) {
      const unsigned send = up ? v[k] : v[k + h];
      const unsigned keep = up ? v[k + h] : v[k];
      v[k] = keep + __shfl_xor_sync(kFull, send, h);
    }
  }
  return v[0];
}

// (at least 4 blocks an SM: a register budget of 128, so ptxas does not
// trade spills for occupancy)
template <int W, bool BOUNDS>
__global__ void __launch_bounds__(kGatherWarps * 32, 4)
gather_int8_kernel(const GatherArgs a) {
  const int lane = threadIdx.x & 31;
  const int j = lane & 7;
  const int quarter = lane & ~7;       // first lane of the quarter
  const long long p0 =
      ((long long)blockIdx.x * kGatherWarps + threadIdx.x / 32) * kRun8;
  if (p0 >= a.n_pairs) return;         // uniform across the warp
  const long long p = p0 + lane;       // this lane's pair, id to store
  const bool in = p < a.n_pairs;
  int id = 0, q = 0;
  bool ok = false;
  if (in) {                            // n_pairs < 2^31: 32-bit division
    if (a.ids != nullptr) id = __ldg(a.ids + p);
    q = a.qi != nullptr ? __ldg(a.qi + p)
                        : (int)(static_cast<unsigned>(p) /
                                static_cast<unsigned>(a.K));
    ok = q >= 0 && q < a.B &&
         (a.ids == nullptr || (id >= 0 && (long long)id < a.N));
  }
  float eq = 0.f, ey = 0.f;            // the slack terms, in flight early
  if (BOUNDS && ok) {
    eq = __ldg(a.qerr + q);
    ey = __ldg(a.err + id);
  }
  const unsigned valid = __ballot_sync(kFull, ok);
  if (valid == 0u) {                   // NO_NODE only: no row is read
    if (in) {
      a.out0[p] = INFINITY;
      if (BOUNDS) a.out1[p] = INFINITY;
    }
    return;
  }
  if (!ok) id = q = 0;                 // a slot that reads nothing
  const int d = a.d, gs = a.gs;
  const int8_t* rowp[kRows];
  int qr[kRows];
  bool okr[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int src = quarter + r;
    const int idr = __shfl_sync(kFull, id, src);
    qr[r] = __shfl_sync(kFull, q, src);
    okr[r] = (valid >> src) & 1u;
    rowp[r] = a.cands + (a.ids != nullptr ? (long long)idr : p0 + src) *
                            (long long)d;
  }
  float fsum = 0.f;                    // lane j: row j's f32 sum
  unsigned carry = 0u;                 // lane j: row j's open group's sum
  for (int b0 = 0; b0 < d; b0 += 8 * W) {   // a pass: 8 chunks of W bytes
    const int k = b0 + j * W;
    const bool has = k < d;
    uint4 c[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      c[r] = has && okr[r] ? load_chunk<W>(rowp[r] + k)
                           : make_uint4(0u, 0u, 0u, 0u);
    unsigned s[kRows];
    uint4 b = has ? load_chunk<W>(a.qx + (long long)qr[0] * d + k)
                  : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r > 0 && qr[r] != qr[r - 1] && has)
        b = load_chunk<W>(a.qx + (long long)qr[r] * d + k);
      s[r] = sq_diff<W>(c[r], b);
    }
    // the groups this pass touches, in order (uniform across the warp)
    const int pe = min(b0 + 8 * W, d);
    const int gk = k / gs;
    for (int g = b0 / gs; g <= (pe - 1) / gs; ++g) {
      const float sc = __ldg(a.scales + g);  // in flight during the sum
      unsigned m[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) m[r] = has && gk == g ? s[r] : 0u;
      carry += quarter_sum8(m, lane);
      if (min((g + 1) * gs, d) <= pe) {     // group g ends in this pass
        fsum = __fadd_rn(fsum, __fmul_rn(__fmul_rn(sc, sc),
                                         (float)(int)carry));
        carry = 0u;
      }
    }
  }
  if (!in) return;
  if (!ok) {
    a.out0[p] = INFINITY;
    if (BOUNDS) a.out1[p] = INFINITY;
    return;
  }
  if (BOUNDS) {
    const float slack = __fadd_rn(eq, ey);
    const float rt = __fsqrt_rn(clamp0(fsum));
    const float l = clamp0(__fsub_rn(rt, slack));
    a.out0[p] = isfinite(fsum) ? __fmul_rn(l, l) : fsum;
    const float u = __fadd_rn(rt, slack);
    a.out1[p] = isfinite(fsum) ? __fmul_rn(u, u) : fsum;
  } else {
    a.out0[p] = fsum;
  }
}

template <int W>
int launch_gather(const GatherArgs& a, cudaStream_t st) {
  const long long per_block = kGatherWarps * kRun8;
  const unsigned blocks =
      static_cast<unsigned>((a.n_pairs + per_block - 1) / per_block);
  if (a.out1 != nullptr)
    gather_int8_kernel<W, true><<<blocks, kGatherWarps * 32, 0, st>>>(a);
  else
    gather_int8_kernel<W, false><<<blocks, kGatherWarps * 32, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
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

extern "C" int repro_rowwise_sq_dists_int8(
    const int8_t* qx, const int8_t* cands, const int* ids, const int* qi,
    const float* scales, const float* err, const float* qerr, float* out0,
    float* out1, long long n_pairs, int K, int d, int gs, long long N, int B,
    int w, void* stream) {
  GatherArgs a{};
  a.qx = qx; a.cands = cands; a.ids = ids; a.qi = qi; a.scales = scales;
  a.err = err; a.qerr = qerr; a.out0 = out0; a.out1 = out1;
  a.n_pairs = n_pairs; a.N = N; a.K = K; a.d = d; a.gs = gs; a.B = B;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 16: return launch_gather<16>(a, st);
    case 8: return launch_gather<8>(a, st);
    case 4: return launch_gather<4>(a, st);
    default: return launch_gather<1>(a, st);
  }
}
