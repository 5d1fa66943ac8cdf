"""Public distance ops: one dispatcher per kernel (port of ``repro.kernels.ops``).

Implementation selection (``impl``) follows the tensors' device:
  * ``cuda`` — the hand-written kernels of ``csrc/*.cu`` (f32 distances,
    the fused NLJ count, int8 distances and the int8 tier's certified
    bounds, the top-k merge, sketch Hamming counts and the sketch tier's
    gather bounds, PDX early-exit distances, their certified bounds and
    the fused PDX band re-rank), for CUDA tensors;
  * ``ref``  — the plain PyTorch versions in ``kernels/ref.py``, for CPU
    tensors (what the CPU tests run).
An explicit ``impl`` must name the one its tensors' device takes.

There is no fallback: a CUDA tensor goes to its kernel or the call raises.
Every shape is accepted, including empty inputs and shapes smaller than
one tile; the kernels mask ragged edges themselves, so nothing is padded.

Each kernel wrapper counts its launches in ``LAUNCHES`` (one per kernel
launch, nowhere else), so a run can show that it went through the
kernels: ``reset_launch_counts()`` before, ``launch_counts()`` after.

The kernels are bound with ctypes, which a dispatch mode (the dry run's
cost counter, ``FakeTensorMode``) cannot see or call. The gather (#3),
the join traversal's hot spot, is also the custom op
``repro_torch::gather_sq_dists`` (CPU: the plain version; CUDA: the
kernel; fake and meta tensors: its shape): ``gather_sq_dists`` goes
through the op when a dispatch mode is active or the tensors are fake or
meta, and launches directly otherwise (the op's dispatch would add host
time a call to a host-bound loop).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

IMPLS = ("ref", "cuda")
LAUNCHES: dict[str, int] = {
    "pairwise_sq_dists": 0, "pairlist_sq_dists": 0, "rowwise_sq_dists": 0,
    "gather_sq_dists": 0, "gather_sq_dists_bf16": 0, "topk_merge": 0,
    "pairwise_sq_dists_int8": 0, "rowwise_sq_dists_int8": 0,
    "pairwise_hamming": 0, "rowwise_hamming": 0,
    "pairwise_sq_dists_pdx": 0, "pairwise_bounds_pdx": 0,
    "pdx_gather_sq_dists": 0, "nlj_count": 0,
    "pairwise_bounds_int8": 0, "gather_sq_dists_pairs": 0,
    "gather_bounds_int8": 0, "gather_bounds_int8_pairs": 0,
    "gather_sketch_bounds": 0, "pdx_compact_gather": 0}
_GRID_Y_MAX = 65535
_MAX_BLOCKS = 2**31 - 1


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def default_impl(t: torch.Tensor) -> str:
    return "cuda" if t.is_cuda else "ref"


def _impl(impl: str | None, t: torch.Tensor) -> str:
    want = default_impl(t)
    if impl is not None and impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")
    if impl is not None and impl != want:
        raise ValueError(f"impl={impl!r} does not take {t.device.type} "
                         f"tensors: 'cuda' runs on CUDA tensors, 'ref' on "
                         f"CPU tensors")
    return want


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device, *, strided_rows: bool = False) -> None:
    """Device, dtype, rank and layout: contiguous, or with
    ``strided_rows`` a 2-D view whose rows are contiguous (the kernel
    takes the row stride)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if strided_rows:
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{name} must have contiguous rows")
    elif not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _vec4(d: int, *ts: torch.Tensor) -> int:
    return int(d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in ts))


def _aligned(width: int, *ts: torch.Tensor) -> int:
    """1 when rows of ``width`` bytes from these bases stay ``width``-
    multiple aligned (the int8 kernels' wide-load paths)."""
    return int(all(t.data_ptr() % width == 0 for t in ts))


def _ptr(t: torch.Tensor | None) -> int | None:
    """A tensor's device address, or NULL for an absent optional input."""
    return None if t is None else t.data_ptr()


def _launch(name: str, dev: torch.device, fn, *args) -> None:
    """One kernel launch: ``fn(*args, stream)`` on the current stream of
    ``dev``, counted in ``LAUNCHES[name]``; raises on a CUDA error code.
    The current device is switched only when it is not ``dev`` already;
    the stream is read as a raw handle (the public ``current_stream``
    builds a Python object a call)."""
    if dev.index == torch.cuda.current_device():
        code = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            code = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    LAUNCHES[name] += 1
    _build.check(code, name)


# ---------------------------------------------------------------------------
# pairwise: (B, d) x (N, d) -> (B, N)
# ---------------------------------------------------------------------------

def pairwise_sq_dists_cuda(x: torch.Tensor, y: torch.Tensor,
                           xn: torch.Tensor | None = None,
                           yn: torch.Tensor | None = None) -> torch.Tensor:
    """The CUDA kernel; x, y contiguous f32 on one card, non-empty;
    ``xn``/``yn`` the rows' squared norms (``ref.sq_norms`` if omitted)."""
    dev = x.device
    _check("x", x, torch.float32, 2, dev)
    _check("y", y, torch.float32, 2, dev)
    B, d = x.shape
    N = y.shape[0]
    if y.shape[1] != d:
        raise ValueError(f"dims differ: x {tuple(x.shape)}, y {tuple(y.shape)}")
    if -(-B // 128) > _GRID_Y_MAX or max(B, N, d) >= 2**31:
        raise ValueError(f"shape too large for one launch: B={B} N={N} d={d}")
    xn = _ref.sq_norms(x) if xn is None else xn
    yn = _ref.sq_norms(y) if yn is None else yn
    _check("xn", xn, torch.float32, 1, dev)
    _check("yn", yn, torch.float32, 1, dev)
    if xn.shape[0] != B or yn.shape[0] != N:
        raise ValueError(f"norms {tuple(xn.shape)}, {tuple(yn.shape)} do not "
                         f"match B={B}, N={N}")
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    _launch("pairwise_sq_dists", dev, _build.load().repro_pairwise_sq_dists,
            x.data_ptr(), y.data_ptr(), xn.data_ptr(), yn.data_ptr(),
            out.data_ptr(), B, N, d, _vec4(d, x, y))
    return out


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor, *,
                      xn: torch.Tensor | None = None,
                      yn: torch.Tensor | None = None,
                      impl: str | None = None) -> torch.Tensor:
    """(B, d) × (N, d) → (B, N) f32 squared L2 distances (matmul form).
    ``xn``/``yn`` pass the rows' squared norms (``ref.sq_norms`` of each
    side when omitted); a caller that must reproduce these values later
    through ``pairlist_sq_dists`` passes one norm tensor to both."""
    impl = _impl(impl, x)
    B, d = x.shape
    N = y.shape[0]
    if B == 0 or N == 0 or d == 0:
        return torch.zeros((B, N), dtype=torch.float32, device=x.device)
    if impl == "ref":
        return _ref.pairwise_sq_dists(x, y, xn, yn)
    return pairwise_sq_dists_cuda(x, y, xn, yn)


# ---------------------------------------------------------------------------
# pair list: (B, d), (N, d), (P,) query ids, (P,) data ids -> (P,)
# ---------------------------------------------------------------------------

def pairlist_sq_dists_cuda(x, y, xn, yn, qi, yi) -> torch.Tensor:
    dev = x.device
    _check("x", x, torch.float32, 2, dev)
    _check("y", y, torch.float32, 2, dev)
    _check("xn", xn, torch.float32, 1, dev)
    _check("yn", yn, torch.float32, 1, dev)
    _check("qi", qi, torch.int32, 1, dev)
    _check("yi", yi, torch.int32, 1, dev)
    B, d = x.shape
    N = y.shape[0]
    P = qi.shape[0]
    if (y.shape[1] != d or yi.shape[0] != P or xn.shape[0] != B
            or yn.shape[0] != N):
        raise ValueError(f"shapes differ: x {tuple(x.shape)}, y "
                         f"{tuple(y.shape)}, norms {tuple(xn.shape)}/"
                         f"{tuple(yn.shape)}, pairs {P}/{yi.shape[0]}")
    if -(-P // 128) > _MAX_BLOCKS or d >= 2**31:
        raise ValueError(f"too many pairs for one launch: {P}")
    out = torch.empty((P,), dtype=torch.float32, device=dev)
    _launch("pairlist_sq_dists", dev, _build.load().repro_pairlist_sq_dists,
            x.data_ptr(), y.data_ptr(), xn.data_ptr(), yn.data_ptr(),
            qi.data_ptr(), yi.data_ptr(), out.data_ptr(), P, d, B, N)
    return out


def pairlist_sq_dists(x: torch.Tensor, y: torch.Tensor, qi: torch.Tensor,
                      yi: torch.Tensor, *, xn: torch.Tensor, yn: torch.Tensor,
                      impl: str | None = None) -> torch.Tensor:
    """(P,) f32 matmul-form squared distances of explicit pairs
    ``(x[qi[p]], y[yi[p]])`` with the given squared norms; an id out of
    range gives +inf. On the card this is the pairwise kernel's own
    arithmetic (same dot, same epilogue), so with the same norm tensors
    each value equals ``pairwise_sq_dists(x, y, xn=xn, yn=yn)[qi, yi]``
    bit for bit — what the sq8 build's exact re-rank relies on."""
    impl = _impl(impl, x)
    if qi.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.float32, device=x.device)
    if impl == "ref":
        return _ref.pairlist_sq_dists(x, y, xn, yn, qi, yi)
    return pairlist_sq_dists_cuda(x, y, xn, yn, qi, yi)


# ---------------------------------------------------------------------------
# NLJ count: (B, d) x (N, d) -> (B,) matches within θ
# ---------------------------------------------------------------------------

def nlj_count_cuda(x: torch.Tensor, y: torch.Tensor, th2: float
                   ) -> torch.Tensor:
    """The CUDA kernel; x, y contiguous f32 on one card, non-empty;
    ``th2`` is θ² rounded to f32."""
    dev = x.device
    _check("x", x, torch.float32, 2, dev)
    _check("y", y, torch.float32, 2, dev)
    B, d = x.shape
    N = y.shape[0]
    if y.shape[1] != d:
        raise ValueError(f"dims differ: x {tuple(x.shape)}, y {tuple(y.shape)}")
    if -(-B // 128) > _GRID_Y_MAX or max(B, N, d) >= 2**31:
        raise ValueError(f"shape too large for one launch: B={B} N={N} d={d}")
    # the norms the pairwise wrapper computes, so each comparison sees the
    # pairwise kernel's value for the pair
    xn, yn = _ref.sq_norms(x), _ref.sq_norms(y)
    out = torch.zeros((B,), dtype=torch.int32, device=dev)
    _launch("nlj_count", dev, _build.load().repro_nlj_count,
            x.data_ptr(), y.data_ptr(), xn.data_ptr(), yn.data_ptr(),
            out.data_ptr(), B, N, d, _vec4(d, x, y), th2)
    return out


def nlj_count(x: torch.Tensor, y: torch.Tensor, *, theta: float,
              impl: str | None = None) -> torch.Tensor:
    """Exact per-query join counts |{j : dist(x_b, y_j) < θ}| → (B,) int32
    (θ on L2, squared in f32). On the card one fused kernel: distance
    tile, compare and row count, with no (B, N) matrix in device memory.
    As the reference: ``B == 0`` gives ``(0,)``, ``N == 0`` zeros, and
    ``d == 0`` (every distance 0) ``N`` when θ > 0, else 0."""
    impl = _impl(impl, x)
    B, d = x.shape
    N = y.shape[0]
    if B == 0:
        return torch.zeros((0,), dtype=torch.int32, device=x.device)
    if N == 0 or d == 0:
        n = N if (d == 0 and theta > 0) else 0
        return torch.full((B,), n, dtype=torch.int32, device=x.device)
    if impl == "ref":
        return _ref.nlj_count(x, y, theta)
    return nlj_count_cuda(x, y, _ref.sq_theta(theta))


def nlj_mask(x: torch.Tensor, y: torch.Tensor, *, theta: float,
             impl: str | None = None) -> torch.Tensor:
    """Exact boolean match matrix (B, N): the pairwise kernel, then the
    compare with θ² (squared in f32)."""
    d = pairwise_sq_dists(x, y, impl=impl)
    return d < _ref.sq_theta(theta)


# ---------------------------------------------------------------------------
# rowwise: (B, d) x (B, K, d) -> (B, K)
# ---------------------------------------------------------------------------

def rowwise_sq_dists_cuda(x: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    dev = x.device
    _check("x", x, torch.float32, 2, dev)
    _check("cands", cands, torch.float32, 3, dev)
    B, d = x.shape
    _, K, dc = cands.shape
    if cands.shape[0] != B or dc != d:
        raise ValueError(f"shapes differ: x {tuple(x.shape)}, "
                         f"cands {tuple(cands.shape)}")
    n_pairs = B * K
    if -(-n_pairs // 8) > _MAX_BLOCKS or max(K, d) >= 2**31:
        raise ValueError(f"shape too large for one launch: {tuple(cands.shape)}")
    out = torch.empty((B, K), dtype=torch.float32, device=dev)
    _launch("rowwise_sq_dists", dev, _build.load().repro_rowwise_sq_dists,
            x.data_ptr(), cands.data_ptr(), out.data_ptr(), n_pairs, K, d,
            _vec4(d, x, cands))
    return out


def rowwise_sq_dists(x: torch.Tensor, cands: torch.Tensor, *,
                     impl: str | None = None) -> torch.Tensor:
    """(B, d) × (B, K, d) → (B, K) f32 per-query candidate distances."""
    impl = _impl(impl, x)
    B, d = x.shape
    K = cands.shape[1]
    if B == 0 or K == 0 or d == 0:
        return torch.zeros((B, K), dtype=torch.float32, device=x.device)
    if impl == "ref":
        return _ref.rowwise_sq_dists(x, cands)
    return rowwise_sq_dists_cuda(x, cands)


# ---------------------------------------------------------------------------
# gather: (N, d) vecs, (B, d) x, (B, K) ids -> (B, K); its pair list
# ---------------------------------------------------------------------------

def _gather_cuda(vecs: torch.Tensor, x: torch.Tensor, ids: torch.Tensor,
                 qi: torch.Tensor | None) -> torch.Tensor:
    """The gather kernel: (B, K) ``ids`` with query row b (``qi`` None),
    or a pair list of (P,) ``ids`` with query rows ``qi``; f32 rows, or
    bf16 rows and queries in the (B, K) form (its bf16 entry)."""
    dev = x.device
    bf16 = vecs.dtype == torch.bfloat16 and qi is None
    dt = torch.bfloat16 if bf16 else torch.float32
    _check("vecs", vecs, dt, 2, dev)
    _check("x", x, dt, 2, dev)
    _check("idx", ids, torch.int32, 2 if qi is None else 1, dev)
    B, d = x.shape
    N = vecs.shape[0]
    if qi is not None:
        _check("qi", qi, torch.int32, 1, dev)
    if (vecs.shape[1] != d or (qi is None and ids.shape[0] != B)
            or (qi is not None and qi.shape != ids.shape)):
        raise ValueError(f"shapes differ: vecs {tuple(vecs.shape)}, x "
                         f"{tuple(x.shape)}, idx {tuple(ids.shape)}"
                         + ("" if qi is None else f", qi {tuple(qi.shape)}"))
    n = ids.numel()
    if n >= 2**31 or max(B, d) >= 2**31:
        raise ValueError(f"shape too large for one launch: {tuple(ids.shape)}")
    out = torch.empty(ids.shape, dtype=torch.float32, device=dev)
    lib = _build.load()
    if bf16:
        vec8 = int(d % 8 == 0 and vecs.data_ptr() % 16 == 0
                   and x.data_ptr() % 16 == 0)
        _launch("gather_sq_dists_bf16", dev, lib.repro_gather_sq_dists_bf16,
                vecs.data_ptr(), x.data_ptr(), ids.data_ptr(),
                out.data_ptr(), n, ids.shape[1], d, N, B, vec8)
        return out
    _launch("gather_sq_dists" if qi is None else "gather_sq_dists_pairs", dev,
            lib.repro_gather_sq_dists, vecs.data_ptr(),
            x.data_ptr(), ids.data_ptr(), _ptr(qi), out.data_ptr(), n,
            1 if qi is not None else ids.shape[1], d, N, B,
            _vec4(d, vecs, x))
    return out


@torch.library.custom_op("repro_torch::gather_sq_dists", mutates_args=(),
                         device_types="cpu")
def _gather_op(vecs: torch.Tensor, x: torch.Tensor, idx: torch.Tensor
               ) -> torch.Tensor:
    """#3 as an op the dispatcher sees: the plain version on the CPU."""
    return _ref.gather_sq_dists(vecs, x, idx)


@_gather_op.register_kernel("cuda")
def _(vecs, x, idx):
    return _gather_cuda(vecs, x, idx, None)


@_gather_op.register_fake
def _(vecs, x, idx):
    return x.new_empty(idx.shape, dtype=torch.float32)


def _dispatched(t: torch.Tensor) -> bool:
    """Whether a call must go through the dispatcher: a dispatch mode is
    active, or ``t`` is a fake (or other subclass) or meta tensor. The op
    then runs what the direct call would: ``_impl`` has already held
    ``impl`` to the tensor's own route (the kernel on CUDA, the plain
    version on the CPU), and raises for any other."""
    return (torch._C._len_torch_dispatch_stack() > 0
            or type(t) is not torch.Tensor or t.is_meta)


def gather_sq_dists(vecs: torch.Tensor, x: torch.Tensor, idx: torch.Tensor,
                    *, impl: str | None = None) -> torch.Tensor:
    """(N,d) vecs × (B,d) queries × (B,K) int32 ids → (B,K) f32 squared
    distances ``rowwise_sq_dists(x, vecs[idx])``, the vectors f32 or both
    bf16 (summed in f32). Ids outside [0, N) (NO_NODE) come back +inf;
    the kernel reads no row for them."""
    impl = _impl(impl, x)
    B, K = idx.shape
    if B == 0 or K == 0:
        return torch.zeros((B, K), dtype=torch.float32, device=x.device)
    if _dispatched(x):
        return _gather_op(vecs, x, idx)
    if impl == "ref":
        return _ref.gather_sq_dists(vecs, x, idx)
    return _gather_cuda(vecs, x, idx, None)


def gather_sq_dists_pairs(vecs: torch.Tensor, x: torch.Tensor,
                          qi: torch.Tensor, yi: torch.Tensor, *,
                          impl: str | None = None) -> torch.Tensor:
    """(P,) f32 difference-form squared distances of explicit pairs
    ``(x[qi[p]], vecs[yi[p]])``, int32 ids: the values of
    ``gather_sq_dists(vecs, x[qi], yi[:, None])[:, 0]`` (bit for bit on
    the card: one kernel), without building ``x[qi]``. An id or a query
    row out of range gives +inf and reads no row."""
    impl = _impl(impl, x)
    if qi.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.float32, device=x.device)
    if impl == "ref":
        return _ref.gather_sq_dists_pairs(vecs, x, qi, yi)
    return _gather_cuda(vecs, x, yi, qi)


# ---------------------------------------------------------------------------
# top-k merge: sorted (B, L) beam ⊕ (B, K) candidates -> (B, L)
# ---------------------------------------------------------------------------

_TOPK_MAX = 12288          # L + K floats of one row in 48 KiB shared memory
_TOPK_WARP_MAX = 64        # L and K that the warp-per-row kernel holds


def topk_merge_cuda(bd, bi, cd, ci) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows with L and K up to 64 (the kNN builds' 48) go to the kernel
    that merges a row in one warp, wider rows to the block-per-row kernel:
    chosen by shape, both exact."""
    dev = bd.device
    _check("beam_dist", bd, torch.float32, 2, dev)
    _check("beam_idx", bi, torch.int32, 2, dev)
    _check("cand_dist", cd, torch.float32, 2, dev)
    _check("cand_idx", ci, torch.int32, 2, dev)
    B, L = bd.shape
    K = cd.shape[1]
    if bi.shape != bd.shape or ci.shape != cd.shape or cd.shape[0] != B:
        raise ValueError(f"shapes differ: beam {tuple(bd.shape)}/"
                         f"{tuple(bi.shape)}, cands {tuple(cd.shape)}/"
                         f"{tuple(ci.shape)}")
    if L + K > _TOPK_MAX or B >= 2**31:
        raise ValueError(f"row too wide for one block: L={L} K={K}")
    od = torch.empty((B, L), dtype=torch.float32, device=dev)
    oi = torch.empty((B, L), dtype=torch.int32, device=dev)
    lib = _build.load()
    fn = (lib.repro_topk_merge_warp
          if L <= _TOPK_WARP_MAX and K <= _TOPK_WARP_MAX
          else lib.repro_topk_merge)
    _launch("topk_merge", dev, fn, bd.data_ptr(), bi.data_ptr(),
            cd.data_ptr(), ci.data_ptr(), od.data_ptr(), oi.data_ptr(), B, L,
            K)
    return od, oi


def topk_merge(beam_dist: torch.Tensor, beam_idx: torch.Tensor,
               cand_dist: torch.Tensor, cand_idx: torch.Tensor, *,
               impl: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge a sorted (B, L) beam with (B, K) candidates; keep the L
    smallest in ascending order. Ties go to the beam, then to the lower
    candidate slot; +inf slots come back as NO_NODE."""
    impl = _impl(impl, beam_dist)
    B, L = beam_dist.shape
    if B == 0 or L == 0:
        return (torch.empty((B, L), dtype=torch.float32,
                            device=beam_dist.device),
                torch.empty((B, L), dtype=torch.int32,
                            device=beam_dist.device))
    if impl == "ref":
        return _ref.topk_merge(beam_dist, beam_idx, cand_dist, cand_idx)
    return topk_merge_cuda(beam_dist, beam_idx, cand_dist, cand_idx)


# ---------------------------------------------------------------------------
# int8 (QuantStore codes)
# ---------------------------------------------------------------------------

def _check_scales(scales: torch.Tensor, d: int, group_size: int,
                  dev: torch.device) -> None:
    _check("scales", scales, torch.float32, 1, dev)
    if group_size <= 0 or scales.shape[0] != -(-d // group_size):
        raise ValueError(f"scales {tuple(scales.shape)} do not cover d={d} "
                         f"in groups of {group_size}")


def _int8_pair_checks(qx, qy, scales, xn, yn, group_size: int,
                      *rows) -> tuple[int, int, int]:
    """Checks shared by the int8 pairwise entries; ``rows`` are further
    (name, tensor, length) f32 vectors. Returns (B, N, d)."""
    dev = qx.device
    _check("qx", qx, torch.int8, 2, dev)
    _check("qy", qy, torch.int8, 2, dev)
    B, d = qx.shape
    N = qy.shape[0]
    if qy.shape[1] != d:
        raise ValueError(f"dims differ: qx {tuple(qx.shape)}, "
                         f"qy {tuple(qy.shape)}")
    for name, t, n in (("xn", xn, B), ("yn", yn, N)) + rows:
        _check(name, t, torch.float32, 1, dev)
        if t.shape[0] != n:
            raise ValueError(f"{name} {tuple(t.shape)} does not match "
                             f"{n} rows")
    _check_scales(scales, d, group_size, dev)
    if -(-B // 128) > _GRID_Y_MAX or max(B, N, d) >= 2**31:
        raise ValueError(f"shape too large for one launch: B={B} N={N} d={d}")
    return B, N, d


def pairwise_sq_dists_int8_cuda(qx, qy, scales, xn, yn, group_size: int
                                ) -> torch.Tensor:
    dev = qx.device
    B, N, d = _int8_pair_checks(qx, qy, scales, xn, yn, group_size)
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    _launch("pairwise_sq_dists_int8", dev,
            _build.load().repro_pairwise_sq_dists_int8,
            qx.data_ptr(), qy.data_ptr(), scales.data_ptr(), xn.data_ptr(),
            yn.data_ptr(), out.data_ptr(), B, N, d, group_size)
    return out


def pairwise_bounds_int8_cuda(qx, qy, scales, xn, yn, xe, ye, guard: float,
                              group_size: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    dev = qx.device
    B, N, d = _int8_pair_checks(qx, qy, scales, xn, yn, group_size,
                                ("xe", xe, qx.shape[0]),
                                ("ye", ye, qy.shape[0]))
    lb = torch.empty((B, N), dtype=torch.float32, device=dev)
    ub = torch.empty((B, N), dtype=torch.float32, device=dev)
    _launch("pairwise_bounds_int8", dev,
            _build.load().repro_pairwise_bounds_int8,
            qx.data_ptr(), qy.data_ptr(), scales.data_ptr(), xn.data_ptr(),
            yn.data_ptr(), xe.data_ptr(), ye.data_ptr(), lb.data_ptr(),
            ub.data_ptr(), B, N, d, group_size, _ref.f32(guard))
    return lb, ub


def _dequant_norms(q: torch.Tensor, scales: torch.Tensor,
                   group_size: int) -> torch.Tensor:
    deq = _ref._dequant(q, scales, group_size)
    return torch.sum(deq * deq, dim=-1)


def pairwise_sq_dists_int8(qx: torch.Tensor, qy: torch.Tensor,
                           scales: torch.Tensor, *, group_size: int = 128,
                           xn: torch.Tensor | None = None,
                           yn: torch.Tensor | None = None,
                           impl: str | None = None) -> torch.Tensor:
    """(B, d) × (N, d) int8 → (B, N) f32 quantized-domain squared L2.

    ``qx``/``qy`` share one scale grid; ``xn``/``yn`` are the dequantized
    squared norms (the store's; recomputed from the codes if omitted)."""
    impl = _impl(impl, qx)
    B, d = qx.shape
    N = qy.shape[0]
    if B == 0 or N == 0 or d == 0:
        return torch.zeros((B, N), dtype=torch.float32, device=qx.device)
    if impl == "ref":
        return _ref.pairwise_sq_dists_int8(qx, qy, scales,
                                           group_size=group_size)
    if xn is None:
        xn = _dequant_norms(qx, scales, group_size)
    if yn is None:
        yn = _dequant_norms(qy, scales, group_size)
    return pairwise_sq_dists_int8_cuda(qx, qy, scales, xn, yn, group_size)


def pairwise_bounds_int8(qx: torch.Tensor, qy: torch.Tensor,
                         scales: torch.Tensor, *, xn: torch.Tensor,
                         yn: torch.Tensor, xe: torch.Tensor, ye: torch.Tensor,
                         guard: float, group_size: int = 128,
                         impl: str | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, d) × (N, d) int8 → the int8 tier's certified (lb, ub) (B, N) on
    the true squared distance: the quantized-domain ``d̂`` of
    ``pairwise_sq_dists_int8`` widened by the matmul guard
    ``guard·(xn + yn)`` and the triangle-inequality slack ``xe + ye``
    (``ref.int8_bounds``). ``xn``/``yn`` are the dequantized squared norms,
    ``xe``/``ye`` the exact per-row L2 quantization errors. On the card one
    kernel writes both, bit for bit the composition over the pairwise
    kernel's ``d̂``; on the CPU the composition itself."""
    impl = _impl(impl, qx)
    B, d = qx.shape
    N = qy.shape[0]
    if impl == "ref" or B == 0 or N == 0 or d == 0:
        dhat = pairwise_sq_dists_int8(qx, qy, scales, group_size=group_size,
                                      xn=xn, yn=yn, impl=impl)
        return _ref.int8_bounds(dhat, xn, yn, xe, ye, guard)
    return pairwise_bounds_int8_cuda(qx, qy, scales, xn, yn, xe, ye, guard,
                                     group_size)


def _int8_diff_cuda(name: str, qx, cands, ids, qi, scales, group_size: int,
                    err=None, qerr=None):
    """The one int8 difference-form kernel: (B, K, d) candidates (``ids``
    None), or rows ``ids`` of the (N, d) code table — (B, K) with query
    row b, or (P,) with query rows ``qi``. With the errors ``err`` (N,)
    and ``qerr`` (B,) it writes the certified (lb, ub), else d̂."""
    dev = qx.device
    _check("qx", qx, torch.int8, 2, dev)
    B, d = qx.shape
    if ids is None:
        _check("qcands", cands, torch.int8, 3, dev)
        if cands.shape[0] != B or cands.shape[2] != d:
            raise ValueError(f"shapes differ: qx {tuple(qx.shape)}, qcands "
                             f"{tuple(cands.shape)}")
        shape, N = tuple(cands.shape[:2]), 0
    else:
        _check("codes", cands, torch.int8, 2, dev)
        _check("idx", ids, torch.int32, 2 if qi is None else 1, dev)
        if qi is not None:
            _check("qi", qi, torch.int32, 1, dev)
        if (cands.shape[1] != d or (qi is None and ids.shape[0] != B)
                or (qi is not None and qi.shape != ids.shape)):
            raise ValueError(f"shapes differ: codes {tuple(cands.shape)}, qx "
                             f"{tuple(qx.shape)}, idx {tuple(ids.shape)}")
        shape, N = tuple(ids.shape), cands.shape[0]
    _check_scales(scales, d, group_size, dev)
    if err is not None:
        for nm, t, n in (("err", err, N), ("qerr", qerr, B)):
            _check(nm, t, torch.float32, 1, dev)
            if t.shape[0] != n:
                raise ValueError(f"{nm} {tuple(t.shape)} does not match {n} "
                                 f"rows")
    n_pairs = shape[0] * (shape[1] if len(shape) == 2 else 1)
    if n_pairs >= 2**31 or max(B, d) >= 2**31:
        raise ValueError(f"shape too large for one launch: {shape}")
    # widest chunk that never straddles a group or a row, on aligned bases
    w = next((w for w in (16, 8, 4) if d % w == 0 and group_size % w == 0
              and _aligned(w, qx, cands)), 1)
    out0 = torch.empty(shape, dtype=torch.float32, device=dev)
    out1 = None if err is None else torch.empty_like(out0)
    _launch(name, dev, _build.load().repro_rowwise_sq_dists_int8,
            qx.data_ptr(), cands.data_ptr(), _ptr(ids), _ptr(qi),
            scales.data_ptr(), _ptr(err), _ptr(qerr), out0.data_ptr(),
            _ptr(out1), n_pairs, shape[1] if qi is None else 1, d,
            group_size, N, B, w)
    return out0 if out1 is None else (out0, out1)


def rowwise_sq_dists_int8(qx: torch.Tensor, qcands: torch.Tensor,
                          scales: torch.Tensor, *, group_size: int = 128,
                          impl: str | None = None) -> torch.Tensor:
    """(B, d) × (B, K, d) int8 → (B, K) f32 quantized-domain squared L2
    (difference form, exact in int32 per group)."""
    impl = _impl(impl, qx)
    B, d = qx.shape
    K = qcands.shape[1]
    if B == 0 or K == 0 or d == 0:
        return torch.zeros((B, K), dtype=torch.float32, device=qx.device)
    if impl == "ref":
        return _ref.rowwise_sq_dists_int8(qx, qcands, scales,
                                          group_size=group_size)
    return _int8_diff_cuda("rowwise_sq_dists_int8", qx, qcands, None, None,
                           scales, group_size)


def gather_sq_dists_int8(codes: torch.Tensor, qx: torch.Tensor,
                         idx: torch.Tensor, scales: torch.Tensor, *,
                         group_size: int = 128,
                         impl: str | None = None) -> torch.Tensor:
    """(N, d) codes × (B, d) query codes × (B, K) int32 ids → (B, K) f32
    ``rowwise_sq_dists_int8(qx, codes[idx])``, without building the
    gathered tensor: the kernel reads each row by id. Ids outside [0, N)
    (NO_NODE) come back +inf and read no row."""
    impl = _impl(impl, qx)
    B, K = idx.shape
    if B == 0 or K == 0:
        return torch.zeros((B, K), dtype=torch.float32, device=qx.device)
    if impl == "ref":
        return _ref.gather_sq_dists_int8(codes, qx, idx, scales,
                                         group_size=group_size)
    return _int8_diff_cuda("rowwise_sq_dists_int8", qx, codes, idx, None,
                           scales, group_size)


def gather_bounds_int8(codes: torch.Tensor, qx: torch.Tensor,
                       idx: torch.Tensor, scales: torch.Tensor, *,
                       err: torch.Tensor, qerr: torch.Tensor,
                       group_size: int = 128, impl: str | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, K) int32 candidate ids → the int8 tier's certified (lb, ub) on
    their true squared distances: the difference-form d̂ of
    ``gather_sq_dists_int8`` widened by the L2 slack ``qerr[b] +
    err[id]`` (``ref.gather_bounds``). On the card one kernel writes both,
    bit for bit the composition over the int8 gather kernel's d̂; +inf at
    NO_NODE. On the CPU the composition itself."""
    impl = _impl(impl, qx)
    B, K = idx.shape
    if B == 0 or K == 0:
        z = torch.zeros((B, K), dtype=torch.float32, device=qx.device)
        return z, z.clone()
    if impl == "ref":
        return _ref.gather_bounds_int8(codes, qx, idx, scales, err, qerr,
                                       group_size=group_size)
    return _int8_diff_cuda("gather_bounds_int8", qx, codes, idx, None,
                           scales, group_size, err, qerr)


def gather_bounds_int8_pairs(codes: torch.Tensor, qx: torch.Tensor,
                             qi: torch.Tensor, yi: torch.Tensor,
                             scales: torch.Tensor, *, err: torch.Tensor,
                             qerr: torch.Tensor, group_size: int = 128,
                             impl: str | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``gather_bounds_int8`` over explicit (query, data) pairs, int32
    ids: (P,) lb and ub of ``(qx[qi[p]], codes[yi[p]])`` with the slack
    ``qerr[qi[p]] + err[yi[p]]``, without building ``qx[qi]``."""
    impl = _impl(impl, qx)
    if qi.shape[0] == 0:
        z = torch.zeros((0,), dtype=torch.float32, device=qx.device)
        return z, z.clone()
    if impl == "ref":
        return _ref.gather_bounds_int8_pairs(codes, qx, qi, yi, scales, err,
                                             qerr, group_size=group_size)
    return _int8_diff_cuda("gather_bounds_int8_pairs", qx, codes, yi, qi,
                           scales, group_size, err, qerr)


# ---------------------------------------------------------------------------
# 1-bit sketch (Hamming) counts — int32 words holding uint32 sign bits
# ---------------------------------------------------------------------------

def pairwise_hamming_cuda(cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    dev = cx.device
    _check("cx", cx, torch.int32, 2, dev)
    _check("cy", cy, torch.int32, 2, dev)
    B, W = cx.shape
    N = cy.shape[0]
    if cy.shape[1] != W:
        raise ValueError(f"words differ: cx {tuple(cx.shape)}, "
                         f"cy {tuple(cy.shape)}")
    if -(-B // 64) > _GRID_Y_MAX or max(B, N, W) >= 2**31:
        raise ValueError(f"shape too large for one launch: B={B} N={N} W={W}")
    out = torch.empty((B, N), dtype=torch.int32, device=dev)
    _launch("pairwise_hamming", dev, _build.load().repro_pairwise_hamming,
            cx.data_ptr(), cy.data_ptr(), out.data_ptr(), B, N, W,
            int(N % 4 == 0 and out.data_ptr() % 16 == 0))
    return out


def pairwise_hamming(cx: torch.Tensor, cy: torch.Tensor, *,
                     impl: str | None = None) -> torch.Tensor:
    """(B, W) × (N, W) int32 sketch words → (B, N) int32 Hamming counts
    (the certified bounds come from ``quant.sketch``)."""
    impl = _impl(impl, cx)
    B, W = cx.shape
    N = cy.shape[0]
    if B == 0 or N == 0 or W == 0:
        return torch.zeros((B, N), dtype=torch.int32, device=cx.device)
    if impl == "ref":
        return _ref.pairwise_hamming(cx, cy)
    return pairwise_hamming_cuda(cx, cy)


def _rowwise_hamming_cuda(cx, cands, ids, K: int) -> torch.Tensor:
    """The one Hamming rowwise kernel: (B, K, W) candidates (``ids``
    None) or rows ``ids`` of the (N, W) code table."""
    dev = cx.device
    _check("cx", cx, torch.int32, 2, dev)
    B, W = cx.shape
    if ids is None:
        _check("ccands", cands, torch.int32, 3, dev)
        if cands.shape[0] != B or cands.shape[2] != W:
            raise ValueError(f"shapes differ: cx {tuple(cx.shape)}, ccands "
                             f"{tuple(cands.shape)}")
        N, ids_ptr = 0, None
    else:
        _check("codes", cands, torch.int32, 2, dev)
        _check("idx", ids, torch.int32, 2, dev)
        if cands.shape[1] != W or ids.shape[0] != B:
            raise ValueError(f"shapes differ: codes {tuple(cands.shape)}, "
                             f"cx {tuple(cx.shape)}, idx {tuple(ids.shape)}")
        N, ids_ptr = cands.shape[0], ids.data_ptr()
    n_pairs = B * K
    if -(-n_pairs // 256) > _MAX_BLOCKS or max(K, W) >= 2**31:
        raise ValueError(f"shape too large for one launch: B={B} K={K}")
    vec4 = int(W % 4 == 0 and _aligned(16, cx, cands))
    out = torch.empty((B, K), dtype=torch.int32, device=dev)
    _launch("rowwise_hamming", dev, _build.load().repro_rowwise_hamming,
            cx.data_ptr(), cands.data_ptr(), ids_ptr, out.data_ptr(), n_pairs,
            K, W, N, vec4)
    return out


def rowwise_hamming(cx: torch.Tensor, ccands: torch.Tensor, *,
                    impl: str | None = None) -> torch.Tensor:
    """(B, W) × (B, K, W) int32 → (B, K) int32 Hamming counts over
    per-query candidate codes."""
    impl = _impl(impl, cx)
    B, W = cx.shape
    K = ccands.shape[1]
    if B == 0 or K == 0 or W == 0:
        return torch.zeros((B, K), dtype=torch.int32, device=cx.device)
    if impl == "ref":
        return _ref.rowwise_hamming(cx, ccands)
    return _rowwise_hamming_cuda(cx, ccands, None, K)


def gather_hamming(codes: torch.Tensor, cx: torch.Tensor, idx: torch.Tensor,
                   *, impl: str | None = None) -> torch.Tensor:
    """(N, W) codes × (B, W) query codes × (B, K) int32 ids → (B, K) int32
    ``rowwise_hamming(cx, codes[idx])`` without building the gathered
    tensor (the kernel reads each row by id). Ids outside [0, N)
    (NO_NODE) read no row and give -1."""
    impl = _impl(impl, cx)
    B, K = idx.shape
    if B == 0 or K == 0:
        return torch.zeros((B, K), dtype=torch.int32, device=cx.device)
    if impl == "ref":
        return _ref.gather_hamming(codes, cx, idx)
    return _rowwise_hamming_cuda(cx, codes, idx, K)


_HS_MAX = 12288            # checkpoints staged in 48 KiB of shared memory


def gather_sketch_bounds_cuda(codes, cx, idx, cum_q, cum_table, hs, iso, *,
                              dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    from repro_torch.quant.sketch import lb_guard
    dev = cx.device
    _check("codes", codes, torch.int32, 2, dev)
    _check("cx", cx, torch.int32, 2, dev)
    _check("idx", idx, torch.int32, 2, dev)
    _check("cum_q", cum_q, torch.float32, 2, dev)
    _check("cum_table", cum_table, torch.float32, 2, dev)
    _check("hs", hs, torch.int32, 1, dev)
    _check("iso", iso, torch.float32, 0, dev)
    B, W = cx.shape
    N = codes.shape[0]
    K = idx.shape[1]
    Kc = hs.shape[0]
    if (codes.shape[1] != W or idx.shape[0] != B
            or tuple(cum_q.shape) != (B, Kc)
            or tuple(cum_table.shape) != (N, Kc)):
        raise ValueError(f"shapes differ: codes {tuple(codes.shape)}, cx "
                         f"{tuple(cx.shape)}, idx {tuple(idx.shape)}, cum_q "
                         f"{tuple(cum_q.shape)}, cum_table "
                         f"{tuple(cum_table.shape)}, hs {tuple(hs.shape)}")
    if dim <= 0 or not 0 < Kc <= _HS_MAX:
        raise ValueError(f"dim={dim} and {Kc} checkpoints: need dim > 0 and "
                         f"1..{_HS_MAX} checkpoints")
    if B * K >= 2**31 or max(N, W) >= 2**31:
        raise ValueError(f"shape too large for one launch: B={B} K={K}")
    lb = torch.empty((B, K), dtype=torch.float32, device=dev)
    est = torch.empty((B, K), dtype=torch.float32, device=dev)
    # the composition's f32 scalars: torch's CUDA division by a scalar
    # multiplies by its f32 reciprocal
    inv_d = float(np.float32(1.0) / np.float32(dim))
    _launch("gather_sketch_bounds", dev,
            _build.load().repro_gather_sketch_bounds, codes.data_ptr(),
            cx.data_ptr(), idx.data_ptr(), cum_q.data_ptr(),
            cum_table.data_ptr(), hs.data_ptr(), iso.data_ptr(),
            lb.data_ptr(), est.data_ptr(), B * K, K, W, N, Kc,
            lb_guard(dim), _ref.f32(math.pi), inv_d,
            int(W % 4 == 0 and _aligned(16, codes, cx)))
    return lb, est


def gather_sketch_bounds(codes: torch.Tensor, cx: torch.Tensor,
                         idx: torch.Tensor, cum_q: torch.Tensor,
                         cum_table: torch.Tensor, hs: torch.Tensor,
                         iso: torch.Tensor, *, dim: int,
                         impl: str | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sketch tier's gather bounds: (N, W) codes × (B, W) query codes
    × (B, K) int32 ids → ``(lb, est)``, (B, K) f32: the certified lower
    bound on each candidate's squared distance from its Hamming count and
    the two slack tables (``cum_q`` (B, Kc), ``cum_table`` (N, Kc) on the
    checkpoints ``hs``, isometry factor ``iso``), and the uncertified
    SimHash estimate ``n_x + n_y − 2√(n_x n_y)·cos(πh/d)``; ids outside
    [0, N) give +inf for both. On the card one kernel, bit for bit the
    composition ``ref.gather_sketch_bounds`` runs there; on the CPU the
    composition itself."""
    impl = _impl(impl, cx)
    B, K = idx.shape
    if impl == "ref":
        return _ref.gather_sketch_bounds(codes, cx, idx, cum_q, cum_table,
                                         hs, iso, dim=dim)
    if B == 0 or K == 0:
        z = torch.zeros((B, K), dtype=torch.float32, device=cx.device)
        return z, z.clone()
    return gather_sketch_bounds_cuda(codes, cx, idx, cum_q, cum_table, hs,
                                     iso, dim=dim)


# ---------------------------------------------------------------------------
# PDX (dimension-partitioned) early-exit distances
# ---------------------------------------------------------------------------

def _pdx_guards(dim: int) -> tuple[float, float]:
    """(relative, absolute) tail-bound deflation at dimension ``dim``."""
    from repro_torch.quant.pdx import TAIL_GUARD, tail_guard
    return tail_guard(dim), TAIL_GUARD


def _pdx_pair_launch(counter: str, fn, qx, qy, scales, xslab, yslab, xtail,
                     ytail, xn, yn, xe, ye, theta: float, *, slab: int,
                     dim: int, early_exit: bool, bounds: bool):
    """The PDX pairwise kernel: (d̂, nscan), or with ``bounds`` the int8
    tier's certified (lb, ub, nscan)."""
    from repro_torch.quant.cascade import MATMUL_GUARD
    dev = qx.device
    _check("qx", qx, torch.int8, 2, dev)
    _check("qy", qy, torch.int8, 2, dev)
    _check("scales", scales, torch.float32, 1, dev)
    B, dp = qx.shape
    N = qy.shape[0]
    S = scales.shape[0]
    if qy.shape[1] != dp or slab <= 0 or S * slab != dp:
        raise ValueError(f"shapes differ: qx {tuple(qx.shape)}, qy "
                         f"{tuple(qy.shape)}, {S} slabs of {slab}")
    for name, t, n in (("xslab", xslab, B), ("yslab", yslab, N),
                        ("xtail", xtail, B), ("ytail", ytail, N)):
        _check(name, t, torch.float32, 2, dev)
        if tuple(t.shape) != (n, S):
            raise ValueError(f"{name} {tuple(t.shape)} is not ({n}, {S})")
    for name, t, n in (("xn", xn, B), ("yn", yn, N), ("xe", xe, B),
                        ("ye", ye, N)):
        _check(name, t, torch.float32, 1, dev)
        if t.shape[0] != n:
            raise ValueError(f"{name} {tuple(t.shape)} is not ({n},)")
    if -(-B // 128) > _GRID_Y_MAX or max(B, N, dp) >= 2**31:
        raise ValueError(f"shape too large for one launch: B={B} N={N}")
    guard, guard_abs = _pdx_guards(dim)
    outs = [torch.empty((B, N), dtype=torch.float32, device=dev)
            for _ in range(2 if bounds else 1)]
    nscan = torch.empty((B, N), dtype=torch.int32, device=dev)
    _launch(counter, dev, fn, qx.data_ptr(), qy.data_ptr(), scales.data_ptr(),
            xslab.data_ptr(), yslab.data_ptr(), xtail.data_ptr(),
            ytail.data_ptr(), xn.data_ptr(), yn.data_ptr(), xe.data_ptr(),
            ye.data_ptr(), *(o.data_ptr() for o in outs), nscan.data_ptr(),
            B, N, S, slab, float(theta), guard, guard_abs, MATMUL_GUARD,
            int(early_exit))
    return (*outs, nscan)


def pairwise_sq_dists_pdx_cuda(qx, qy, scales, xslab, yslab, xtail, ytail,
                               xn, yn, xe, ye, theta: float, *, slab: int,
                               dim: int, early_exit: bool):
    return _pdx_pair_launch(
        "pairwise_sq_dists_pdx", _build.load().repro_pairwise_sq_dists_pdx,
        qx, qy, scales, xslab, yslab, xtail, ytail, xn, yn, xe, ye, theta,
        slab=slab, dim=dim, early_exit=early_exit, bounds=False)


def pairwise_bounds_pdx_cuda(qx, qy, scales, xslab, yslab, xtail, ytail, xn,
                             yn, xe, ye, theta: float, *, slab: int, dim: int,
                             early_exit: bool):
    return _pdx_pair_launch(
        "pairwise_bounds_pdx", _build.load().repro_pairwise_bounds_pdx,
        qx, qy, scales, xslab, yslab, xtail, ytail, xn, yn, xe, ye, theta,
        slab=slab, dim=dim, early_exit=early_exit, bounds=True)


def pairwise_sq_dists_pdx(qx, qy, scales, xslab, yslab, xtail, ytail, xn,
                          yn, xe, ye, theta: float, *, slab: int, dim: int,
                          early_exit: bool = False, impl: str | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """PDX early-exit quantized pairwise distances (the NLJ tier shape):
    (B, S·slab) × (N, S·slab) int8 PDX codes → ``(dhat, nscan)``, (B, N)
    f32 (+inf where a lane retired on its certified tail bound against the
    L2 threshold ``theta``) and (B, N) int32 slabs scanned. Survivors'
    sums are bit-identical with ``early_exit`` on and off."""
    impl = _impl(impl, qx)
    B = qx.shape[0]
    N = qy.shape[0]
    if B == 0 or N == 0:
        return (torch.zeros((B, N), dtype=torch.float32, device=qx.device),
                torch.zeros((B, N), dtype=torch.int32, device=qx.device))
    if impl == "ref":
        return _ref.pairwise_sq_dists_pdx(
            qx, qy, scales, xslab, yslab, xtail, ytail, xn, yn, xe, ye,
            theta, slab=slab, dim=dim, early_exit=early_exit)
    return pairwise_sq_dists_pdx_cuda(
        qx, qy, scales, xslab, yslab, xtail, ytail, xn, yn, xe, ye, theta,
        slab=slab, dim=dim, early_exit=early_exit)


def pairwise_bounds_pdx(qx, qy, scales, xslab, yslab, xtail, ytail, xn, yn,
                        xe, ye, theta: float, *, slab: int, dim: int,
                        early_exit: bool = False, impl: str | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``pairwise_sq_dists_pdx`` with the int8 tier's certified bounds of
    its ``dhat`` (``ref.int8_bounds``: the matmul guard
    ``MATMUL_GUARD·(xn + yn)`` and the slack ``xe + ye``) →
    ``(lb, ub, nscan)``, +inf in both bounds where a lane retired. On the
    card one kernel writes all three, bit for bit the composition over
    ``pairwise_sq_dists_pdx``'s ``dhat``; on the CPU the composition
    itself (``ref.pairwise_bounds_pdx``)."""
    impl = _impl(impl, qx)
    B = qx.shape[0]
    N = qy.shape[0]
    if impl == "ref" or B == 0 or N == 0:
        return _ref.pairwise_bounds_pdx(
            qx, qy, scales, xslab, yslab, xtail, ytail, xn, yn, xe, ye,
            theta, slab=slab, dim=dim, early_exit=early_exit)
    return pairwise_bounds_pdx_cuda(
        qx, qy, scales, xslab, yslab, xtail, ytail, xn, yn, xe, ye, theta,
        slab=slab, dim=dim, early_exit=early_exit)


def pdx_gather_sq_dists_cuda(vp, vtail, vnorm, xp, xtail, xn, idx,
                             th2: float, *, dim: int, early_exit: bool):
    dev = xp.device
    _check("vp", vp, torch.float32, 2, dev)
    _check("vtail", vtail, torch.float32, 2, dev)
    _check("vnorm", vnorm, torch.float32, 1, dev)
    _check("xp", xp, torch.float32, 2, dev)
    _check("xtail", xtail, torch.float32, 2, dev)
    _check("xn", xn, torch.float32, 1, dev)
    _check("idx", idx, torch.int32, 2, dev)
    B, dp = xp.shape
    N, S = vtail.shape
    K = idx.shape[1]
    if (vp.shape != (N, dp) or xtail.shape != (B, S) or S == 0
            or dp % S or vnorm.shape[0] != N or xn.shape[0] != B
            or idx.shape[0] != B):
        raise ValueError(f"shapes differ: vp {tuple(vp.shape)}, vtail "
                         f"{tuple(vtail.shape)}, xp {tuple(xp.shape)}, xtail "
                         f"{tuple(xtail.shape)}, idx {tuple(idx.shape)}")
    slab = dp // S
    n_pairs = B * K
    if -(-n_pairs // 8) > _MAX_BLOCKS or max(K, dp) >= 2**31:
        raise ValueError(f"shape too large for one launch: B={B} K={K}")
    guard, guard_abs = _pdx_guards(dim)
    vec4 = int(slab % 4 == 0 and _aligned(16, vp, xp))
    out = torch.empty((B, K), dtype=torch.float32, device=dev)
    nscan = torch.empty((B, K), dtype=torch.int32, device=dev)
    _launch("pdx_gather_sq_dists", dev,
            _build.load().repro_pdx_gather_sq_dists,
            vp.data_ptr(), vtail.data_ptr(), vnorm.data_ptr(), xp.data_ptr(),
            xtail.data_ptr(), xn.data_ptr(), idx.data_ptr(), out.data_ptr(),
            nscan.data_ptr(), n_pairs, K, S, slab, N, float(th2), guard,
            guard_abs, int(early_exit), vec4)
    return out, nscan


def pdx_gather_sq_dists(vp, vtail, vnorm, xp, xtail, xn, idx, th2: float, *,
                        dim: int, early_exit: bool = False,
                        impl: str | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused PDX gather + early-exit f32 distance over candidate ids:
    (N, S·slab) PDX rows × (B, S·slab) PDX queries × (B, K) int32 ids →
    ``(dist, nscan)``. NO_NODE slots read no row and give (+inf, 0);
    lanes retired against ``th2`` (θ²) give +inf; survivors carry the
    slab-ordered f32 sum, bit-identical with ``early_exit`` on and off."""
    impl = _impl(impl, xp)
    B, K = idx.shape
    if B == 0 or K == 0:
        return (torch.zeros((B, K), dtype=torch.float32, device=xp.device),
                torch.zeros((B, K), dtype=torch.int32, device=xp.device))
    if impl == "ref":
        return _ref.pdx_gather_sq_dists(vp, vtail, vnorm, xp, xtail, xn, idx,
                                        th2, dim=dim, early_exit=early_exit)
    return pdx_gather_sq_dists_cuda(vp, vtail, vnorm, xp, xtail, xn, idx, th2,
                                    dim=dim, early_exit=early_exit)


# ---------------------------------------------------------------------------
# quantization error → certified distance bounds
# ---------------------------------------------------------------------------

quant_lower_bound = _ref.quant_lower_bound
quant_upper_bound = _ref.quant_upper_bound


def quant_band_from_lb(lb: torch.Tensor, slack: torch.Tensor, th2
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sure, ambiguous) split of lower-bound survivors: the matching
    upper bound is ``quant_upper_bound(lb, 2·slack)``; sure entries are
    certified true pairs, ambiguous ones need the exact kernel."""
    ub = quant_upper_bound(lb, 2.0 * slack)
    sure = ub < th2
    return sure, ~sure


# ---------------------------------------------------------------------------
# band compaction — sparse re-rank over a boolean band mask
# ---------------------------------------------------------------------------

band_compact = _ref.band_compact
band_scatter = _ref.band_scatter


def compact_gather_sq_dists(vecs: torch.Tensor, x: torch.Tensor,
                            ids: torch.Tensor, mask: torch.Tensor, cap: int,
                            *, impl: str | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Exact f32 distances for the masked slots of a pooled id matrix
    through a ``cap``-wide compacted gather (the f32 gather kernel sees
    only B × cap ids). Returns ``(exact (B, C), +inf off the re-ranked
    slots; within (B, C) — masked slots ranked below cap; n_masked)``."""
    C = ids.shape[1]
    slots, cand, n_masked = band_compact(mask, ids, cap)
    exact = band_scatter(slots, gather_sq_dists(vecs, x, cand, impl=impl), C)
    within = mask & (torch.cumsum(mask, dim=1) - 1 < cap)
    return exact, within, n_masked


def pdx_compact_gather_cuda(vp, vtail, vnorm, xp, xtail, xn, ids, mask,
                            cap: int, th2: float, *, dim: int,
                            early_exit: bool):
    dev = xp.device
    for name, t in (("vp", vp), ("vtail", vtail), ("xp", xp),
                    ("xtail", xtail)):
        _check(name, t, torch.float32, 2, dev)
    _check("vnorm", vnorm, torch.float32, 1, dev)
    _check("xn", xn, torch.float32, 1, dev)
    _check("ids", ids, torch.int32, 2, dev, strided_rows=True)
    _check("mask", mask, torch.bool, 2, dev, strided_rows=True)
    B, dp = xp.shape
    N, S = vtail.shape
    C = ids.shape[1]
    if (vp.shape != (N, dp) or xtail.shape != (B, S) or S == 0
            or dp % S or vnorm.shape[0] != N or xn.shape[0] != B
            or ids.shape[0] != B or mask.shape != ids.shape):
        raise ValueError(f"shapes differ: vp {tuple(vp.shape)}, vtail "
                         f"{tuple(vtail.shape)}, xp {tuple(xp.shape)}, xtail "
                         f"{tuple(xtail.shape)}, ids {tuple(ids.shape)}, "
                         f"mask {tuple(mask.shape)}")
    if max(B, C, dp + S, dim) >= 2**31 or (dp + S) * 4 > 227 * 1024:
        raise ValueError(f"shape too large for one launch: B={B} C={C} "
                         f"dims={dp}")
    slab = dp // S
    guard, guard_abs = _pdx_guards(dim)
    exact = torch.empty((B, C), dtype=torch.float32, device=dev)
    within = torch.empty((B, C), dtype=torch.bool, device=dev)
    n_masked = torch.empty((B,), dtype=torch.int32, device=dev)
    counts = torch.zeros((2,), dtype=torch.int64, device=dev)
    # the bare gather's lane map: 16-byte chunks on these bases, else words
    vec4 = int(slab % 4 == 0 and _aligned(16, vp, xp))
    _launch("pdx_compact_gather", dev, _build.load().repro_pdx_compact_gather,
            vp.data_ptr(), vtail.data_ptr(), vnorm.data_ptr(), xp.data_ptr(),
            xtail.data_ptr(), xn.data_ptr(), ids.data_ptr(), mask.data_ptr(),
            exact.data_ptr(), within.data_ptr(), n_masked.data_ptr(),
            counts.data_ptr(), B, C, ids.stride(0), mask.stride(0),
            min(cap, C), S, slab, N, float(th2), guard, guard_abs, dim,
            int(early_exit), vec4)
    return exact, within, n_masked, counts[0], counts[1]


def pdx_compact_gather_sq_dists(vp, vtail, vnorm, xp, xtail, xn, ids,
                                mask, cap: int, th2: float, *, dim: int,
                                early_exit: bool = False,
                                impl: str | None = None):
    """PDX twin of ``compact_gather_sq_dists``: the early-exit re-rank of
    the masked band slots ranked below ``cap`` (the pdx8 / sketchpdx8 band
    re-rank). Returns ``(exact, within, n_masked, n_scanned, n_total)`` —
    the first three as there (``exact`` is +inf on retired and on
    uncompacted slots), then the dimensions scanned and the dimensions of
    a full scan over the compacted lanes with an id ≥ 0, as 0-d int64
    tensors on the device. On the card one kernel, bit for bit the
    composition ``band_compact`` → ``pdx_gather_sq_dists`` →
    ``band_scatter`` there; on the CPU that composition
    (``ref.pdx_compact_gather_sq_dists``)."""
    impl = _impl(impl, xp)
    if impl == "ref":
        return _ref.pdx_compact_gather_sq_dists(
            vp, vtail, vnorm, xp, xtail, xn, ids, mask, cap, th2, dim=dim,
            early_exit=early_exit)
    B, C = ids.shape
    if B == 0 or C == 0:
        z = torch.zeros((), dtype=torch.int64, device=xp.device)
        return (torch.full((B, C), torch.inf, device=xp.device),
                torch.zeros((B, C), dtype=torch.bool, device=xp.device),
                torch.zeros((B,), dtype=torch.int32, device=xp.device),
                z, z.clone())
    return pdx_compact_gather_cuda(vp, vtail, vnorm, xp, xtail, xn, ids, mask,
                                   cap, th2, dim=dim, early_exit=early_exit)


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def grow_cap(cur: int, needed: int, limit: int) -> int:
    """Next power of two covering ``needed``, never shrinking, clamped to
    ``limit`` (the band-capacity growth rule)."""
    return min(max(next_pow2(needed), cur), limit)


class StickyCap:
    """Sticky power-of-two grow-and-retry capacity (see
    ``repro.engine.waves.StickyCap``): the one shape of every fixed-width
    device buffer that a sparse set is compacted into — the re-rank band
    (``engine.waves.RerankCap``) and the sq8 build's kNN survivors."""

    def __init__(self, init: int, limit: int):
        self.limit = limit
        self.cap = min(next_pow2(max(init, 1)), limit)

    def grow(self, needed: int) -> None:
        self.cap = grow_cap(self.cap, needed, self.limit)
