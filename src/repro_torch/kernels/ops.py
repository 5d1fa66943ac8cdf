"""Public distance ops: one dispatcher per kernel (port of ``repro.kernels.ops``).

Implementation selection (``impl``) follows the tensors' device:
  * ``cuda`` — the hand-written kernels of ``csrc/distance.cu``, for CUDA
    tensors;
  * ``ref``  — the plain PyTorch versions in ``kernels/ref.py``, for CPU
    tensors (what the CPU tests run).
An explicit ``impl`` must name the one its tensors' device takes.

There is no fallback: a CUDA tensor goes to its kernel or the call raises.
Every shape is accepted, including empty inputs and shapes smaller than
one tile; the kernels mask ragged edges themselves, so nothing is padded.

Each kernel wrapper counts its launches in ``LAUNCHES`` (one per kernel
launch, nowhere else), so a run can show that it went through the
kernels: ``reset_launch_counts()`` before, ``launch_counts()`` after.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

IMPLS = ("ref", "cuda")
LAUNCHES: dict[str, int] = {"pairwise_sq_dists": 0, "rowwise_sq_dists": 0,
                            "gather_sq_dists": 0}
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
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _vec4(d: int, *ts: torch.Tensor) -> int:
    return int(d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in ts))


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------------------
# pairwise: (B, d) x (N, d) -> (B, N)
# ---------------------------------------------------------------------------

def pairwise_sq_dists_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel; x, y contiguous f32 on one card, non-empty."""
    dev = x.device
    _check("x", x, torch.float32, 2, dev)
    _check("y", y, torch.float32, 2, dev)
    B, d = x.shape
    N = y.shape[0]
    if y.shape[1] != d:
        raise ValueError(f"dims differ: x {tuple(x.shape)}, y {tuple(y.shape)}")
    if -(-B // 128) > _GRID_Y_MAX or max(B, N, d) >= 2**31:
        raise ValueError(f"shape too large for one launch: B={B} N={N} d={d}")
    xn = _ref.sq_norms(x).contiguous()
    yn = _ref.sq_norms(y).contiguous()
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        code = lib.repro_pairwise_sq_dists(
            x.data_ptr(), y.data_ptr(), xn.data_ptr(), yn.data_ptr(),
            out.data_ptr(), B, N, d, _vec4(d, x, y), _stream(dev))
    LAUNCHES["pairwise_sq_dists"] += 1
    _build.check(code, "pairwise_sq_dists")
    return out


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor, *,
                      impl: str | None = None) -> torch.Tensor:
    """(B, d) × (N, d) → (B, N) f32 squared L2 distances (matmul form)."""
    impl = _impl(impl, x)
    B, d = x.shape
    N = y.shape[0]
    if B == 0 or N == 0 or d == 0:
        return torch.zeros((B, N), dtype=torch.float32, device=x.device)
    if impl == "ref":
        return _ref.pairwise_sq_dists(x, y)
    return pairwise_sq_dists_cuda(x, y)


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
    lib = _build.load()
    with torch.cuda.device(dev):
        code = lib.repro_rowwise_sq_dists(
            x.data_ptr(), cands.data_ptr(), out.data_ptr(), n_pairs, K, d,
            _vec4(d, x, cands), _stream(dev))
    LAUNCHES["rowwise_sq_dists"] += 1
    _build.check(code, "rowwise_sq_dists")
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
# gather: (N, d) vecs, (B, d) x, (B, K) ids -> (B, K)
# ---------------------------------------------------------------------------

def gather_sq_dists_cuda(vecs: torch.Tensor, x: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    dev = x.device
    _check("vecs", vecs, torch.float32, 2, dev)
    _check("x", x, torch.float32, 2, dev)
    _check("idx", idx, torch.int32, 2, dev)
    B, d = x.shape
    N = vecs.shape[0]
    K = idx.shape[1]
    if vecs.shape[1] != d or idx.shape[0] != B:
        raise ValueError(f"shapes differ: vecs {tuple(vecs.shape)}, "
                         f"x {tuple(x.shape)}, idx {tuple(idx.shape)}")
    n_pairs = B * K
    if -(-n_pairs // 8) > _MAX_BLOCKS or max(K, d) >= 2**31:
        raise ValueError(f"shape too large for one launch: {tuple(idx.shape)}")
    out = torch.empty((B, K), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        code = lib.repro_gather_sq_dists(
            vecs.data_ptr(), x.data_ptr(), idx.data_ptr(), out.data_ptr(),
            n_pairs, K, d, N, _vec4(d, vecs, x), _stream(dev))
    LAUNCHES["gather_sq_dists"] += 1
    _build.check(code, "gather_sq_dists")
    return out


def gather_sq_dists(vecs: torch.Tensor, x: torch.Tensor, idx: torch.Tensor,
                    *, impl: str | None = None) -> torch.Tensor:
    """(N,d) vecs × (B,d) queries × (B,K) int32 ids → (B,K) f32 squared
    distances ``rowwise_sq_dists(x, vecs[idx])``. Ids outside [0, N)
    (NO_NODE) come back +inf; the kernel reads no row for them."""
    impl = _impl(impl, x)
    B, K = idx.shape
    if B == 0 or K == 0:
        return torch.zeros((B, K), dtype=torch.float32, device=x.device)
    if impl == "ref":
        return _ref.gather_sq_dists(vecs, x, idx)
    return gather_sq_dists_cuda(vecs, x, idx)


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def grow_cap(cur: int, needed: int, limit: int) -> int:
    """Next power of two covering ``needed``, never shrinking, clamped to
    ``limit`` (the band-capacity growth rule)."""
    return min(max(next_pow2(needed), cur), limit)
