// The int8 tensor-core tile shared by the int8 pairwise kernels (int8.cu,
// entries 1 and 1') and the PDX pairwise kernels (pdx.cu, entries 1 and
// 1'): its shape, the cp.async ring's loads, the ldmatrix / mma.sync
// fragments, the epilogue's streaming stores, and the int8 tier's
// certified-bound chain.
//
// A 256-thread block keeps kBM query rows resident in shared memory (the
// whole padded depth) and walks a strip of kBN-row data tiles through a
// kStages-deep cp.async ring of kKC-byte depth chunks; 8 warps of 32x32
// outputs run mma.sync.m16n8k32 s8·s8→s32 on fragments read with ldmatrix
// (both operands K-contiguous rows, padded to a 16-byte-odd stride:
// conflict-free). Each dimension group (an int8 scale group, or a PDX
// slab) is zero-padded to a multiple of 32 in shared memory, so no k32
// step straddles two groups. C fragment (mi, ni, e) of a thread is row
// wm·32 + mi·16 + grp + 8·(e >> 1), column wn·32 + ni·8 + 2·tig + (e & 1)
// of the block tile (warp = 2·wm + wn, lane = 4·grp + tig).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_i8 {

constexpr int kThreads = 256;
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

inline Geo make_geo(int d, int gs) {
  Geo g;
  g.d = d;
  g.gs = gs;
  g.G = (d + gs - 1) / gs;
  g.gsp = (gs + 31) / 32 * 32;
  g.Kp = (g.G - 1) * g.gsp + (d - (g.G - 1) * gs + 31) / 32 * 32;
  return g;
}

inline bool aligned(const void* p, int w) {
  return reinterpret_cast<uintptr_t>(p) % w == 0;
}

// The widest cp.async piece (16, 8 or 4 bytes) that d, gs and both code
// bases allow; 0: byte loads
inline int piece_width(int d, int gs, const void* qx, const void* qy) {
  for (int w = 16; w >= 4; w /= 2)
    if (d % w == 0 && gs % w == 0 && aligned(qx, w) && aligned(qy, w))
      return w;
  return 0;
}

// (tiles a block, grid) for B query rows against N data rows: a strip of
// data tiles per block, about eight blocks an SM in all
inline int strip_grid(int B, int N, dim3* grid) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int ntm = (B + kBM - 1) / kBM;
  const int ntn = (N + kBN - 1) / kBN;
  const int strips = max(1, min(ntn, (8 * sms + ntm - 1) / ntm));
  const int tpb = (ntn + strips - 1) / strips;
  *grid = dim3((ntn + tpb - 1) / tpb, ntm);
  return tpb;
}

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

// One k32 step of a warp's 32x32 outputs: the A fragments of its 32 query
// rows from xb, the B fragments of its 32 data rows from yb, 8 MMAs
__device__ __forceinline__ void warp_mma_k32(int (&acc)[2][4][4],
                                             const int8_t* xb, int xstride,
                                             const int8_t* yb, int ystride,
                                             int wm, int wn, int lane,
                                             int kk) {
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
}

// torch.clamp_min(v, 0): NaN passes through
__device__ __forceinline__ float clamp0(float v) {
  return v != v ? v : fmaxf(v, 0.f);
}

// The int8 tier's certified bounds from a matmul-form d̂ (ref.int8_bounds):
// guard = f32(MATMUL_GUARD)·(xn + yn), lb = max(√max(d̂ − guard, 0) −
// slack, 0)², ub = (√max(d̂ + guard, 0) + slack)², +inf and NaN passed
// through as torch's where/clamp pass them, every step rounded on its own
// (no fma contraction), so both equal torch's composition bit for bit
__device__ __forceinline__ void bound_chain(float dh, float nsum, float slack,
                                            float mguard, float& lb,
                                            float& ub) {
  const float guard = __fmul_rn(mguard, nsum);
  const float lo = clamp0(__fsub_rn(dh, guard));
  const float l = clamp0(__fsub_rn(__fsqrt_rn(clamp0(lo)), slack));
  lb = isfinite(lo) ? __fmul_rn(l, l) : lo;
  const float hi = __fadd_rn(dh, guard);
  const float u = __fadd_rn(__fsqrt_rn(clamp0(hi)), slack);
  ub = isfinite(hi) ? __fmul_rn(u, u) : hi;
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

}  // namespace repro_i8
