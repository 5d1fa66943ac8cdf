// Hand-written Hopper (sm_90a) kernels for PDX (dimension-partitioned)
// squared-L2 distances with certified mid-vector early exit, over PdxStore
// rows (repro_torch/quant/pdx.py: dimensions permuted by descending
// variance, padded to S slabs of `slab` dimensions, one int8 scale per
// slab).
//
// All entries accumulate a lane's distance slab by slab. With early exit a
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
//    on the true distance exceeds theta^2. Writes (d̂, nscan).
// 1'. repro_pairwise_bounds_pdx — the same kernel with the int8 tier's
//    certified-bound chain in its epilogue (bound_chain of int8_tile.cuh,
//    the chain of int8.cu's entry 1'), as quant/cascade.py PdxTier's NLJ
//    sweep takes it: writes (lb, ub, nscan), bit for bit
//    ref.int8_bounds over entry 1's d̂ (+inf passes through both bounds).
//    Eager torch ran ~17 passes over each (B, N) f32 block for the chain.
//    Bound: at the pdx8 NLJ's block (512 queries x 1M rows, S = 2) the
//    outputs are the bytes: (d̂, nscan) 4 GiB, (lb, ub, nscan) 6 GiB, 1.28
//    and 1.92 ms at 3.35 TB/s; the int8 MACs (~0.07 ms on the int8
//    tensor-core peak) and the epilogue's f32 steps sit below them.
//    Design: the int8 pairwise tile (int8_tile.cuh) with a slab as the
//    dimension group: 128 query rows resident, a 3-stage cp.async ring of
//    64-row data tiles, 8 warps of 32x32 outputs on mma.sync s8·s8→s32.
//    Per-tile tables in shared memory, once per block tile: the rows' √xtail,
//    xslab, xn, xe and θ + xe at the block's start; each data tile's √ytail,
//    yslab, yn, ye, issued with the previous tile's last chunk (a ring of
//    kTabSlots) and square-rooted once when they land. (Where the depth is
//    too large for the query tile and the tables to fit, the query tile
//    streams through the ring and the tables are read from global memory
//    at use.) At each slab end the int32 slab dots become the slab's f32
//    contributions and the next slab's retirement test runs, both per C
//    fragment element; a per-thread 32-bit mask holds which of its 32
//    lanes are live, and a retired lane keeps its slab count in its (no
//    longer needed) sum. A warp whose 32x32 lanes have all retired skips
//    the tile's remaining MMAs (a warp-uniform vote), as the TPU kernel
//    skips a block with no live lane. The epilogue stages each warp's
//    outputs 16 rows at a time in a swizzled slice of shared memory and
//    writes them as 16-byte streaming stores of whole 128-byte row
//    segments (a C fragment's own 8-byte store touches 8 rows, 4 MB apart
//    at N = 1M, and the write traffic sets the time).
//    Every f32 step is rounded on its own (__fadd_rn & co., no fma
//    contraction) in the plain version's order, and the int32 dots are
//    exact in any order, so the outputs are the plain version's bit for
//    bit, and survivors are bit-identical with early exit on and off (the
//    retirement test never writes a live lane's sum).
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
//
// 2'. repro_pdx_compact_gather — entry 2 with the wave pipeline's band
//    compaction fused in (kernels/ops.py pdx_compact_gather_sq_dists, the
//    pdx8 / sketchpdx8 band re-rank of engine/waves.py): over a (B, C) pool
//    of ids and its band mask, each masked slot ranked below cap among the
//    row's masked slots is re-ranked at its own column; every other column
//    reads +inf. Writes exact (B, C), within = mask & rank < cap, n_masked
//    (B,) and the two scan counters (dims scanned, min(nscan·slab, d)
//    summed over the compacted lanes with an id >= 0, and d times their
//    count) by 64-bit integer atomics, exact in any order. It replaces
//    band_compact → entry 2 → band_scatter and ~34 eager ops around them
//    (kernels/ref.py pdx_compact_gather_sq_dists).
//    Bits: dist and nscan are entry 2's. A pair's lanes keep entry 2's
//    per-lane slab map and XOR tree on a group of G lanes, G the power of
//    two that covers the slab's chunks (up to a warp): where G < 32 the
//    lanes past G held entry 2's exact zeros and its tree's first steps
//    added them, so the tree's last log2(G) steps give the same sums.
//    Bound: bytes — the pool's ids and mask, the scanned slabs of each
//    compacted valid row, and the outputs.
//    Design: `parts` blocks a pool row (enough blocks to fill the card at
//    B = 256); each scans the row's mask by warp ballots a 256-slot chunk
//    at a time (the next chunk's mask loading meanwhile) into a
//    rank-ordered list of band columns and their ids in shared memory (the
//    ids read there, coalesced, and not at the head of each pair's chain
//    of dependent loads), then its groups take every parts·(256/G)-th
//    entry. The query's PDX
//    row and its S tail roots sit in shared memory, read once a block;
//    a group loads its slab with 16-byte loads (a half-warp at slab 64).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "int8_tile.cuh"

namespace {

using namespace repro_i8;

// the deflated tail bound and the threshold test, in the plain version's
// operation order
__device__ __forceinline__ float tail_bound(float sx, float sy, float energy,
                                            float guard, float guard_abs) {
  const float dd = __fsub_rn(sx, sy);
  const float rt = __fmul_rn(dd, dd);
  return fmaxf(__fsub_rn(__fsub_rn(rt, __fmul_rn(guard, energy)), guard_abs),
               0.f);
}

// ---------------------------------------------------------------------------
// 1, 1'. pairwise on the tensor cores (the tile of int8_tile.cuh)
// ---------------------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;
// column-table slots: a tile's table is issued with the previous tile's
// last chunk, three steps before that chunk is read, and read through the
// tile's own last chunk
constexpr int kTabSlots = kStages + 1;

struct PdxArgs {
  const int8_t* qx;
  const int8_t* qy;
  const float* scales;
  const float* xslab;      // (B, S) per-slab dequantized energies
  const float* yslab;      // (N, S)
  const float* xtail;      // (B, S) suffix energies by slab
  const float* ytail;      // (N, S)
  const float* xn;         // (B,) dequantized squared norms
  const float* yn;
  const float* xe;         // (B,) L2 quantization errors
  const float* ye;
  float* out0;             // d̂, or lb
  float* out1;             // ub (bounds only)
  int* nscan;              // slabs scanned
  int B, N, S;
  Geo g;                   // d = S·slab, one group a slab
  int vw, tpb, vec4_out;
  float theta, guard, guard_abs, mguard;
};

// Shared tables (f32). The block's rows, [part][kBM]: part k < S √xtail_k,
// S + k xslab_k, 2S xn, 2S + 1 xe, 2S + 2 θ + xe. A tile's columns,
// [part][kBN] in its slot: k < S √ytail_k, S + k yslab_k, 2S yn, 2S + 1 ye.
__host__ __device__ constexpr int row_parts(int S) { return 2 * S + 3; }
__host__ __device__ constexpr int col_parts(int S) { return 2 * S + 2; }

// The columns [col0, col0 + kBN) of the (N, S) and (N,) tables into a
// slot, transposed, in 4-byte cp.async pieces (the (N, S) tables read in
// order); columns past N read 0. The tails land raw: sqrt_cols takes
// their roots once they have landed.
__device__ __forceinline__ void load_cols(float* dst, const PdxArgs& a,
                                          long long col0) {
  const int S = a.S;
  const int n = kBN * col_parts(S);
  for (int u = threadIdx.x; u < n; u += kThreads) {
    const float* src;
    int part, c;
    if (u < 2 * kBN * S) {
      const bool tail = u < kBN * S;
      const int v = tail ? u : u - kBN * S;
      c = v / S;
      const int k = v - c * S;
      part = tail ? k : S + k;
      src = (tail ? a.ytail : a.yslab) + (col0 + c) * S + k;
    } else {
      const int v = u - 2 * kBN * S;
      part = 2 * S + v / kBN;
      c = v % kBN;
      src = (v < kBN ? a.yn : a.ye) + col0 + c;
    }
    const bool ok = col0 + c < a.N;
    cp_async(dst + part * kBN + c, ok ? src : a.yn, 4, ok);
  }
}

__device__ __forceinline__ void sqrt_cols(float* slot, int S) {
  for (int u = threadIdx.x; u < kBN * S; u += kThreads)
    slot[u] = __fsqrt_rn(slot[u]);
}

// The row and column values the slab ends and the epilogue read, by block
// row r and tile column c (a column pair c, c + 1 for the columns): the
// staged shared tables (SMEM), or where the query tile streams (large S,
// whose tables do not fit beside it) the global tables read at use, rows
// and columns past the edge reading 0.
template <bool SMEM>
struct Tabs {
  const PdxArgs& a;
  const float* rtab;       // SMEM: the block's rows
  const float* ct;         // SMEM: the tile's slot
  long long row0, col0;

  __device__ float xn(int r) const {
    if (SMEM) return rtab[2 * a.S * kBM + r];
    const long long i = row0 + r;
    return i < a.B ? __ldg(a.xn + i) : 0.f;
  }
  __device__ float xe(int r) const {
    if (SMEM) return rtab[(2 * a.S + 1) * kBM + r];
    const long long i = row0 + r;
    return i < a.B ? __ldg(a.xe + i) : 0.f;
  }
  __device__ float xtail_rt(int k, int r) const {
    if (SMEM) return rtab[k * kBM + r];
    const long long i = row0 + r;
    return i < a.B ? __fsqrt_rn(__ldg(a.xtail + i * a.S + k)) : 0.f;
  }
  __device__ float xslab(int k, int r) const {
    if (SMEM) return rtab[(a.S + k) * kBM + r];
    const long long i = row0 + r;
    return i < a.B ? __ldg(a.xslab + i * a.S + k) : 0.f;
  }
  __device__ float theta_xe(int r) const {
    if (SMEM) return rtab[(2 * a.S + 2) * kBM + r];
    return __fadd_rn(a.theta, xe(r));
  }
  // columns c, c + 1: part k < S √ytail_k, S + k yslab_k, 2S yn, 2S + 1 ye
  __device__ float2 cols(int part, int c) const {
    if (SMEM) return *reinterpret_cast<const float2*>(ct + part * kBN + c);
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const long long j = col0 + c + e;
      const int S = a.S;
      v[e] = j >= a.N      ? 0.f
             : part < S     ? __fsqrt_rn(__ldg(a.ytail + j * S + part))
             : part < 2 * S ? __ldg(a.yslab + j * S + part - S)
             : part == 2 * S ? __ldg(a.yn + j)
                             : __ldg(a.ye + j);
    }
    return make_float2(v[0], v[1]);
  }
};

// Slab k's retirement test on a thread's live lanes: acc + tail_k <= th,
// th = (θ + xe + ye)² + mguard·(xn + yn), in the plain version's order. A
// lane that fails retires and keeps k (its slab count) in its sum.
// FIRST: slab 0, where every lane is live and acc is 0 (0 + tail_0 is
// tail_0, a max with 0). Returns whether any lane of the warp's 32x32 is
// still live (uniform).
template <bool FIRST, bool SMEM>
__device__ __forceinline__ bool retire(int k, const Tabs<SMEM>& tb,
                                       float (&sum)[2][4][4],
                                       unsigned& alive, int wm, int wn,
                                       int lane) {
  const PdxArgs& a = tb.a;
  const int S = a.S, grp = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 32 + mi * 16 + grp + 8 * h;
      const float sx = tb.xtail_rt(k, r);
      const float xnr = tb.xn(r);
      const float ax = tb.theta_xe(r);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn * 32 + ni * 8 + 2 * tig;
        const float2 sy = tb.cols(k, c);
        const float2 yc = tb.cols(2 * S, c);
        const float2 ec = tb.cols(2 * S + 1, c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * h + e;
          const unsigned bit = 1u << (mi * 16 + ni * 4 + i);
          if (!FIRST && !(alive & bit)) continue;
          const float energy = __fadd_rn(xnr, e ? yc.y : yc.x);
          const float t = __fadd_rn(ax, e ? ec.y : ec.x);
          const float th =
              __fadd_rn(__fmul_rn(t, t), __fmul_rn(a.mguard, energy));
          const float tl = tail_bound(sx, e ? sy.y : sy.x, energy, a.guard,
                                      a.guard_abs);
          if (!((FIRST ? tl : __fadd_rn(sum[mi][ni][i], tl)) <= th)) {
            alive &= ~bit;
            sum[mi][ni][i] = __int_as_float(k);
          }
        }
      }
    }
  return __any_sync(kFull, alive != 0u);
}

// Slab k's contribution max(xslab + yslab − 2·s²·dot, 0), added to a
// thread's live lanes (every lane without early exit); the int32 dots
// restart at 0.
template <bool EE, bool SMEM>
__device__ __forceinline__ void add_slab(int k, const Tabs<SMEM>& tb,
                                         int (&acc)[2][4][4],
                                         float (&sum)[2][4][4],
                                         unsigned alive, int wm, int wn,
                                         int lane) {
  const int S = tb.a.S, grp = lane >> 2, tig = lane & 3;
  const float sc = __ldg(tb.a.scales + k);
  const float t2 = __fmul_rn(2.f, __fmul_rn(sc, sc));
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float xsl = tb.xslab(k, wm * 32 + mi * 16 + grp + 8 * h);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float2 ysl = tb.cols(S + k, wn * 32 + ni * 8 + 2 * tig);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * h + e;
          const float cv = fmaxf(
              __fsub_rn(__fadd_rn(xsl, e ? ysl.y : ysl.x),
                        __fmul_rn(t2, (float)acc[mi][ni][i])),
              0.f);
          if (!EE || (alive >> (mi * 16 + ni * 4 + i)) & 1u)
            sum[mi][ni][i] = __fadd_rn(sum[mi][ni][i], cv);
          acc[mi][ni][i] = 0;
        }
      }
    }
}

// A warp's staging slice: per output array, 16 rows x 32 columns, 16-byte
// chunks swizzled by row (chunk ^ row % 8), so the fragment writes (8-byte,
// a quad of lanes per row) and the row reads (16-byte, 8 lanes a row) are
// both free of bank conflicts.
constexpr int kStageArr = 16 * 32;
__host__ __device__ constexpr int stage_floats(bool bounds) {
  return (bounds ? 3 : 2) * kStageArr;
}
__device__ __forceinline__ int stage_at(int row, int chunk) {
  return row * 32 + ((chunk ^ (row & 7)) << 2);
}

// Four columns of row r as one 16-byte streaming store where they are in
// range and aligned, else element by element.
template <typename T, typename T4>
__device__ __forceinline__ void store_quad(T* __restrict__ out, long long r,
                                           long long c, int B, int N,
                                           int vec4, T4 v) {
  if (r >= B) return;
  T* o = out + r * (long long)N + c;
  if (vec4 && c + 3 < N) {
    __stcs(reinterpret_cast<T4*>(o), v);
  } else {
    if (c < N) o[0] = v.x;
    if (c + 1 < N) o[1] = v.y;
    if (c + 2 < N) o[2] = v.z;
    if (c + 3 < N) o[3] = v.w;
  }
}

// XRES: the query tile stays resident at its whole padded depth, and the
// row and column tables are staged in shared memory; else the query
// tile's chunks stream through the ring too and the tables are read from
// global memory at use (a depth too large for both to fit). EE: retire
// lanes on their certified tail bound. BOUNDS: write (lb, ub) in place of
// d̂.
template <bool XRES, bool EE, bool BOUNDS>
__global__ void __launch_bounds__(kThreads, 2)
pdx_pairwise_kernel(const PdxArgs a) {
  extern __shared__ __align__(16) int8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;   // 4 x 2 warps of 32 x 32
  const int grp = lane >> 2, tig = lane & 3;
  const long long row0 = (long long)blockIdx.y * kBM;
  const int t0 = blockIdx.x * a.tpb;
  const int ntile = min(a.tpb, (a.N + kBN - 1) / kBN - t0);
  if (ntile <= 0) return;                    // uniform over the block
  const int S = a.S;
  const int Kp = a.g.Kp;
  const int nch = (Kp + kKC - 1) / kKC;
  const int nwork = ntile * nch;             // (tile, depth chunk) steps
  const int xstride = XRES ? Kp + kPad : kKC + kPad;
  constexpr int ystride = kKC + kPad;
  int8_t* xs = smem;
  int8_t* ys = smem + (XRES ? kBM : kStages * kBM) * xstride;
  float* stg = reinterpret_cast<float*>(ys + kStages * kBN * ystride) +
               warp * stage_floats(BOUNDS);
  float* rtab = reinterpret_cast<float*>(ys + kStages * kBN * ystride) +
                kThreads / 32 * stage_floats(BOUNDS);
  float* ctab = rtab + row_parts(S) * kBM;   // XRES only, as rtab
  const int ctsz = col_parts(S) * kBN;

  auto issue = [&](int w) {
    const int s = w % kStages;
    const int lt = w / nch, c = w % nch;
    const int len = min(kKC, Kp - c * kKC);
    load_rows(ys + s * kBN * ystride, ystride, a.qy,
              (long long)(t0 + lt) * kBN, a.N, kBN, c * kKC, len, a.g, a.vw);
    if (!XRES)
      load_rows(xs + s * kBM * xstride, xstride, a.qx, row0, a.B, kBM,
                c * kKC, len, a.g, a.vw);
    if (XRES && c == nch - 1 && lt + 1 < ntile)   // the next tile's columns
      load_cols(ctab + (lt + 1) % kTabSlots * ctsz, a,
                (long long)(t0 + lt + 1) * kBN);
  };

  if (XRES) {
    load_rows(xs, xstride, a.qx, row0, a.B, kBM, 0, Kp, a.g, a.vw);
    load_cols(ctab, a, (long long)t0 * kBN);
  }
  cp_async_commit();
#pragma unroll
  for (int w = 0; w < kStages - 1; ++w) {
    if (w < nwork) issue(w);
    cp_async_commit();
  }
  if (XRES) {
    // the row table, once for the whole strip
    for (int u = threadIdx.x; u < row_parts(S) * kBM; u += kThreads) {
      const int part = u / kBM;
      const long long r = row0 + (u - part * kBM);
      float v = 0.f;
      if (r < a.B) {
        if (part < S) {
          v = __fsqrt_rn(__ldg(a.xtail + r * S + part));
        } else if (part < 2 * S) {
          v = __ldg(a.xslab + r * S + part - S);
        } else if (part == 2 * S) {
          v = __ldg(a.xn + r);
        } else {
          const float e = __ldg(a.xe + r);
          v = part == 2 * S + 1 ? e : __fadd_rn(a.theta, e);
        }
      }
      rtab[u] = v;
    }
    cp_async_wait<kStages - 1>();            // tile 0's columns
    __syncthreads();
    sqrt_cols(ctab, S);                      // published by the next barrier
  }

  int acc[2][4][4];
  float sum[2][4][4];        // a live lane's sum; a retired one's slab count
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][ni][e] = 0;
        sum[mi][ni][e] = 0.f;
      }
  unsigned alive = ~0u;      // bit mi·16 + ni·4 + e: that lane is live
  bool wlive = true;         // some lane of the warp's 32x32 is live
  const int spg = a.g.gsp / 32;              // k32 steps of a slab
  const int nsteps = Kp / 32;

  for (int w = 0; w < nwork; ++w) {
    cp_async_wait<kStages - 2>();            // step w's chunk has landed
    __syncthreads();
    // the stage refilled here was read in step w - 1, which every thread
    // finished before the barrier above
    if (w + kStages - 1 < nwork) issue(w + kStages - 1);
    cp_async_commit();
    const int s = w % kStages;
    const int lt = w / nch, c = w % nch;
    // the next tile's columns landed with this chunk: their tails' roots,
    // published by the next step's barrier
    if (XRES && c == nch - 1 && lt + 1 < ntile)
      sqrt_cols(ctab + (lt + 1) % kTabSlots * ctsz, S);
    const long long colt = (long long)(t0 + lt) * kBN;
    const Tabs<XRES> tb{a, rtab, ctab + lt % kTabSlots * ctsz, row0, colt};
    const int8_t* xb = XRES ? xs + c * kKC : xs + s * kBM * xstride;
    const int8_t* yb = ys + s * kBN * ystride;
    const int steps = min(kKC, Kp - c * kKC) / 32;
    if (EE && c == 0)
      wlive = retire<true>(0, tb, sum, alive, wm, wn, lane);
#pragma unroll
    for (int st = 0; st < kKC / 32; ++st) {
      if (st >= steps) break;
      // a warp whose lanes have all retired skips the rest of the tile's
      // MMAs (warp-uniform)
      if (wlive)
        warp_mma_k32(acc, xb, xstride, yb, ystride, wm, wn, lane, st * 32);
      const int ks = c * (kKC / 32) + st;
      if (wlive && ((ks + 1) % spg == 0 || ks + 1 == nsteps)) {  // slab end
        const int k = min(ks / spg, S - 1);
        add_slab<EE>(k, tb, acc, sum, alive, wm, wn, lane);
        if (EE && k + 1 < S)
          wlive = retire<false>(k + 1, tb, sum, alive, wm, wn, lane);
      }
    }
    if (c != nch - 1) continue;

    // epilogue of tile lt, 16 rows of the warp's 32 at a time: (d̂ or (lb,
    // ub), nscan) into the warp's staging slice by C fragment, then out as
    // whole row segments
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rw = grp + 8 * h;          // row of the warp's 16
        const int rl = wm * 32 + mi * 16 + rw;
        const float xnr = tb.xn(rl);
        const float xer = BOUNDS ? tb.xe(rl) : 0.f;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int cl = wn * 32 + ni * 8 + 2 * tig;
          float2 yc = make_float2(0.f, 0.f), ec = yc;
          if (BOUNDS) {
            yc = tb.cols(2 * S, cl);
            ec = tb.cols(2 * S + 1, cl);
          }
          float v0[2], v1[2];
          int ns[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * h + e;
            const bool ok = !EE || (alive >> (mi * 16 + ni * 4 + i)) & 1u;
            ns[e] = ok ? S : __float_as_int(sum[mi][ni][i]);
            if (BOUNDS) {
              // a retired lane's +inf passes through the chain as +inf;
              // it is set here, not fed to the square roots (whose slow
              // path takes +inf and 0)
              bound_chain(ok ? sum[mi][ni][i] : 1.f,
                          __fadd_rn(xnr, e ? yc.y : yc.x),
                          __fadd_rn(xer, e ? ec.y : ec.x), a.mguard, v0[e],
                          v1[e]);
              v0[e] = ok ? v0[e] : INFINITY;
              v1[e] = ok ? v1[e] : INFINITY;
            } else {
              v0[e] = ok ? sum[mi][ni][i] : INFINITY;
            }
          }
          const int o = stage_at(rw, 2 * ni + (tig >> 1)) + (2 * tig & 3);
          *reinterpret_cast<float2*>(stg + o) = make_float2(v0[0], v0[1]);
          if (BOUNDS)
            *reinterpret_cast<float2*>(stg + kStageArr + o) =
                make_float2(v1[0], v1[1]);
          *reinterpret_cast<int2*>(stg + (BOUNDS ? 2 : 1) * kStageArr + o) =
              make_int2(ns[0], ns[1]);
        }
      }
      __syncwarp();
      // the warp's 16 x 32 block: 8 lanes a row, 16 bytes a lane, so each
      // store writes 4 whole 128-byte row segments
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int rw = 4 * p + (lane >> 3), ch = lane & 7;
        const int o = stage_at(rw, ch);
        const long long r = row0 + wm * 32 + mi * 16 + rw;
        const long long col = colt + wn * 32 + 4 * ch;
        store_quad(a.out0, r, col, a.B, a.N, a.vec4_out,
                   *reinterpret_cast<const float4*>(stg + o));
        if (BOUNDS)
          store_quad(a.out1, r, col, a.B, a.N, a.vec4_out,
                     *reinterpret_cast<const float4*>(stg + kStageArr + o));
        store_quad(a.nscan, r, col, a.B, a.N, a.vec4_out,
                   *reinterpret_cast<const int4*>(
                       stg + (BOUNDS ? 2 : 1) * kStageArr + o));
      }
      __syncwarp();                          // before the next 16 rows
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[mi][ni][e] = 0.f;
    alive = ~0u;
    wlive = true;
  }
  cp_async_wait<0>();
}

template <bool XRES, bool EE, bool BOUNDS>
int launch_pdx(const PdxArgs& a, dim3 grid, int smem, cudaStream_t stream) {
  auto kernel = pdx_pairwise_kernel<XRES, EE, BOUNDS>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool EE, bool BOUNDS>
int launch_pdx_res(const PdxArgs& a, bool resident, dim3 grid, int smem,
                   cudaStream_t st) {
  return resident ? launch_pdx<true, EE, BOUNDS>(a, grid, smem, st)
                  : launch_pdx<false, EE, BOUNDS>(a, grid, smem, st);
}

int pdx_pairwise(PdxArgs a, int slab, int early_exit, void* stream) {
  a.g = make_geo(a.S * slab, slab);
  a.vw = piece_width(a.g.d, slab, a.qx, a.qy);
  const bool bounds = a.out1 != nullptr;
  // 16-byte stores need every output row 16-byte aligned
  a.vec4_out = a.N % 4 == 0 && aligned(a.out0, 16) && aligned(a.nscan, 16) &&
               (!bounds || aligned(a.out1, 16));
  const int ring = kStages * kBN * (kKC + kPad);
  const int stage = 4 * kThreads / 32 * stage_floats(bounds);
  const int tabs =
      4 * (row_parts(a.S) * kBM + kTabSlots * col_parts(a.S) * kBN);
  const int xres = kBM * (a.g.Kp + kPad) + ring + stage + tabs;
  const bool resident = xres <= kSmemMax;
  const int smem =
      resident ? xres : kStages * kBM * (kKC + kPad) + ring + stage;
  dim3 grid;
  a.tpb = strip_grid(a.B, a.N, &grid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (early_exit)
    return bounds ? launch_pdx_res<true, true>(a, resident, grid, smem, st)
                  : launch_pdx_res<true, false>(a, resident, grid, smem, st);
  return bounds ? launch_pdx_res<false, true>(a, resident, grid, smem, st)
                : launch_pdx_res<false, false>(a, resident, grid, smem, st);
}

// ---------------------------------------------------------------------------
// 2. the f32 gather
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// 2'. the band compaction with the f32 gather fused in
// ---------------------------------------------------------------------------

constexpr int kBandList = 1024;     // band columns staged a round

// A thread's share of the scan counters: dims scanned and lanes (ids >= 0)
struct BandScan {
  long long dims, lanes;
};

// The pool row's band slots ranked [done, done + n) sit in cols[0, n) and
// their ids in list_ids[0, n); this block's groups re-rank every
// stride-th one: dist goes to exact; returns the group leader's scan
// counts (0 elsewhere).
template <bool EE>
__device__ __forceinline__ BandScan pdx_band_round(
    const int* cols, const int* list_ids, int n, const float* __restrict__ vp,
    const float* __restrict__ vtail, const float* __restrict__ vnorm,
    const float* xs, const float* sx, float xnb,
    float* __restrict__ exact, long long row0, int S, int slab, long long N,
    float th2, float guard, float guard_abs, int dim, int vec4, int G,
    unsigned gmask, int first, int stride) {
  const int gl = threadIdx.x & (G - 1);
  const long long dp = (long long)S * slab;
  BandScan cnt{0, 0};
  for (int j = first; j < n; j += stride) {
    const int col = cols[j];
    const int id = list_ids[j];
    float dist = INFINITY;
    int k = 0;
    if (id >= 0 && (long long)id < N) {
      const float* v = vp + (long long)id * dp;
      const float energy = __fadd_rn(xnb, __ldg(vnorm + id));
      float acc = 0.f;
      for (; k < S; ++k) {
        if (EE) {
          const float tl =
              tail_bound(sx[k], sqrtf(__ldg(vtail + (long long)id * S + k)),
                         energy, guard, guard_abs);
          if (!(__fadd_rn(acc, tl) <= th2)) break;     // group-uniform
        }
        const int g0 = k * slab;
        float s = 0.f;
        if (vec4) {
          for (int i = g0 + 4 * gl; i < g0 + slab; i += 4 * G) {
            const float4 a = __ldg(reinterpret_cast<const float4*>(v + i));
            const float4 q = *reinterpret_cast<const float4*>(xs + i);
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
          for (int i = g0 + gl; i < g0 + slab; i += G) {
            const float t = __fsub_rn(__ldg(v + i), xs[i]);
            s = __fadd_rn(s, __fmul_rn(t, t));
          }
        }
        for (int o = G >> 1; o > 0; o >>= 1)
          s = __fadd_rn(s, __shfl_xor_sync(gmask, s, o));
        acc = __fadd_rn(acc, s);
      }
      if (k == S) dist = acc;
    }
    if (gl == 0) {
      exact[row0 + col] = dist;
      if (id >= 0) {
        cnt.lanes += 1;
        cnt.dims += min((long long)k * slab, (long long)dim);
      }
    }
  }
  return cnt;
}

// grid (B, parts); dynamic shared memory: the query's PDX row (S·slab f32)
// and its S tail roots. counts = {dims scanned, dims of a full scan}. The
// pool's ids and mask rows may be strided (ld_ids, ld_mask elements), as
// a traversal's pool is a view of a wider buffer.
template <bool EE>
__global__ void __launch_bounds__(kThreads, 4)
pdx_compact_gather_kernel(
    const float* __restrict__ vp, const float* __restrict__ vtail,
    const float* __restrict__ vnorm, const float* __restrict__ xp,
    const float* __restrict__ xtail, const float* __restrict__ xn,
    const int* __restrict__ ids, const unsigned char* __restrict__ mask,
    float* __restrict__ exact, unsigned char* __restrict__ within,
    int* __restrict__ n_masked, unsigned long long* __restrict__ counts,
    int C, long long ld_ids, long long ld_mask, int cap, int S, int slab,
    long long N, float th2, float guard, float guard_abs, int dim, int vec4,
    int G) {
  extern __shared__ __align__(16) float qrow[];
  __shared__ int cols[kBandList];       // band columns in rank order
  __shared__ int list_ids[kBandList];   // and their ids
  __shared__ int warp_tot[kThreads / 32];
  __shared__ unsigned long long red[2];
  const int b = blockIdx.x;
  const int part = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long dp = (long long)S * slab;
  const long long row0 = (long long)b * C;
  const int* row_ids = ids + (long long)b * ld_ids;
  const unsigned char* row_mask = mask + (long long)b * ld_mask;
  bool m_next = tid < C && row_mask[tid] != 0;
  float* sx = qrow + dp;
  for (long long i = tid; i < dp; i += kThreads)
    qrow[i] = __ldg(xp + (long long)b * dp + i);
  for (int k = tid; k < S; k += kThreads)
    sx[k] = sqrtf(__ldg(xtail + (long long)b * S + k));
  if (tid < 2) red[tid] = 0ull;
  const float xnb = __ldg(xn + b);
  const unsigned gmask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane & ~(G - 1));
  const int groups = kThreads / G;
  const int first = part * groups + tid / G;
  const int stride = gridDim.y * groups;
  BandScan cnt{0, 0};
  int total = 0;       // masked slots seen so far (block-uniform)
  int done = 0;        // band columns re-ranked in earlier rounds
  __syncthreads();
  for (int c0 = 0; c0 < C; c0 += kThreads) {
    const int listed = min(total, cap) - done;
    if (listed + kThreads > kBandList) {
      const BandScan r = pdx_band_round<EE>(
          cols, list_ids, listed, vp, vtail, vnorm, qrow, sx, xnb, exact,
          row0, S, slab, N, th2, guard, guard_abs, dim, vec4, G, gmask, first,
          stride);
      cnt.dims += r.dims;
      cnt.lanes += r.lanes;
      done += listed;
      __syncthreads();                  // the list is free again
    }
    const int c = c0 + tid;
    const bool m = m_next;
    // the next chunk's mask while this one is ranked
    m_next = c + kThreads < C && row_mask[c + kThreads] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, m);
    if (lane == 0) warp_tot[warp] = __popc(bal);
    __syncthreads();
    int before = 0, chunk = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      const int t = warp_tot[w];
      before += w < warp ? t : 0;
      chunk += t;
    }
    const int rank = total + before + __popc(bal & ((1u << lane) - 1u));
    const bool in = m && rank < cap;
    if (in) {                  // the ids load here, coalesced, not per pair
      cols[rank - done] = c;
      list_ids[rank - done] = __ldg(row_ids + c);
    }
    if (part == 0 && c < C) {
      within[row0 + c] = in;
      if (!in) exact[row0 + c] = INFINITY;
    }
    total += chunk;
    __syncthreads();                    // warp_tot reread, list complete
  }
  const BandScan r = pdx_band_round<EE>(
      cols, list_ids, min(total, cap) - done, vp, vtail, vnorm, qrow, sx, xnb,
      exact, row0, S, slab, N, th2, guard, guard_abs, dim, vec4, G, gmask,
      first, stride);
  cnt.dims += r.dims;
  cnt.lanes += r.lanes;
  if (cnt.lanes > 0) {
    atomicAdd(&red[0], static_cast<unsigned long long>(cnt.dims));
    atomicAdd(&red[1], static_cast<unsigned long long>(cnt.lanes * dim));
  }
  __syncthreads();
  if (tid == 0) {
    if (red[0]) atomicAdd(counts, red[0]);
    if (red[1]) atomicAdd(counts + 1, red[1]);
    if (part == 0) n_masked[b] = total;
  }
}

}  // namespace

extern "C" int repro_pairwise_sq_dists_pdx(
    const int8_t* qx, const int8_t* qy, const float* scales, const float* xslab,
    const float* yslab, const float* xtail, const float* ytail, const float* xn,
    const float* yn, const float* xe, const float* ye, float* out, int* nscan,
    int B, int N, int S, int slab, float theta, float guard, float guard_abs,
    float mguard, int early_exit, void* stream) {
  const PdxArgs a{qx, qy, scales, xslab, yslab, xtail, ytail, xn, yn, xe, ye,
                  out, nullptr, nscan, B, N, S, Geo{}, 0, 0, 0,
                  theta, guard, guard_abs, mguard};
  return pdx_pairwise(a, slab, early_exit, stream);
}

extern "C" int repro_pairwise_bounds_pdx(
    const int8_t* qx, const int8_t* qy, const float* scales, const float* xslab,
    const float* yslab, const float* xtail, const float* ytail, const float* xn,
    const float* yn, const float* xe, const float* ye, float* lb, float* ub,
    int* nscan, int B, int N, int S, int slab, float theta, float guard,
    float guard_abs, float mguard, int early_exit, void* stream) {
  const PdxArgs a{qx, qy, scales, xslab, yslab, xtail, ytail, xn, yn, xe, ye,
                  lb, ub, nscan, B, N, S, Geo{}, 0, 0, 0,
                  theta, guard, guard_abs, mguard};
  return pdx_pairwise(a, slab, early_exit, stream);
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

extern "C" int repro_pdx_compact_gather(
    const float* vp, const float* vtail, const float* vnorm, const float* xp,
    const float* xtail, const float* xn, const int* ids,
    const unsigned char* mask, float* exact, unsigned char* within,
    int* n_masked, unsigned long long* counts, int B, int C, long long ld_ids,
    long long ld_mask, int cap, int S, int slab, long long N, float th2,
    float guard, float guard_abs, int dim, int early_exit, int vec4,
    void* stream) {
  // the lanes that cover a slab's chunks, as a power of two up to a warp
  const int chunks = vec4 ? (slab + 3) / 4 : slab;
  int G = 1;
  while (G < chunks && G < 32) G <<= 1;
  // about four blocks of 256 threads for each of the card's SMs at B = 256
  const dim3 grid(B, B >= 1024 ? 1 : min(8, (1024 + B - 1) / B));
  const int smem = (S * slab + S) * static_cast<int>(sizeof(float));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = early_exit ? pdx_compact_gather_kernel<true>
                           : pdx_compact_gather_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kThreads, smem, st>>>(vp, vtail, vnorm, xp, xtail, xn, ids,
                                       mask, exact, within, n_masked, counts,
                                       C, ld_ids, ld_mask, cap, S, slab, N,
                                       th2, guard, guard_abs, dim, vec4, G);
  return static_cast<int>(cudaGetLastError());
}
