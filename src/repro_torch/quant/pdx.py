"""PdxStore — dimension-partitioned (PDX) storage with certified tail
bounds for mid-vector early exit (port of ``repro.quant.pdx``).

Dimensions are permuted once by descending variance and padded to whole
slabs of ``slab`` dimensions, so the distance kernels accumulate slab by
slab and can retire a lane as soon as its partial sum plus a certified
bound on the remaining dimensions exceeds the threshold:

    partial_k(x, y) + (√tail_x(k) − √tail_y(k))² ≤ ‖x − y‖²

(reverse triangle inequality on the suffix energies ``tail(k)``),
deflated by ``deflate_tail`` for f32 rounding. Retirement is certified,
so the pairs a join emits are the same with early exit on and off.

The store carries an f32 PDX mirror (``vp``/``ftail``) for the re-rank
band's gather kernel and int8 codes on a per-slab grid (``q``, one scale
per slab, with ``qslab``/``qtail`` and the exact per-row error) for the
NLJ's pairwise kernel. The permutation and the scales are the reference's
numpy code (identical values); ``_encode`` is the one code scheme of
stores and queries, whose f32 reductions agree with XLA's to rounding.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.quant.store import _EPS, arrays_nbytes, quantize_on_grid

DEFAULT_SLAB = 64

# absolute + per-dim relative f32 rounding allowance of the tail bound
# (the reference's constants)
TAIL_GUARD = 1e-4
TAIL_GUARD_PER_DIM = 4 * 1.2e-7


def tail_guard(d: int) -> float:
    """Per-unit-energy deflation coefficient for tail bounds at dim ``d``."""
    return TAIL_GUARD_PER_DIM * max(d, 1)


def deflate_tail(rt: torch.Tensor, energy: torch.Tensor,
                 d: int) -> torch.Tensor:
    """``max(rt − tail_guard(d)·energy − TAIL_GUARD, 0)``: the raw tail
    bound ``rt`` less its rounding allowance (``energy`` is the pair's
    summed squared norms), with both constants rounded to f32 as the
    kernels receive them. Deflating a lower bound only makes retirement
    rarer."""
    return torch.clamp_min(rt - float(np.float32(tail_guard(d))) * energy
                           - float(np.float32(TAIL_GUARD)), 0.0)


def n_slabs(d: int, slab: int = DEFAULT_SLAB) -> int:
    return max(-(-d // slab), 1)


@dataclasses.dataclass(frozen=True)
class PdxStore:
    """Dimension-partitioned companion of a vector table."""
    perm: torch.Tensor       # (d,) int32 variance-descending dim permutation
    vp: torch.Tensor         # (N, S·slab) f32 permuted, zero-padded rows
    ftail: torch.Tensor      # (N, S) f32 suffix energies of vp by slab
    q: torch.Tensor          # (N, S·slab) int8 codes on the per-slab grid
    scales: torch.Tensor     # (S,) f32 per-slab dequant scales
    qslab: torch.Tensor      # (N, S) f32 per-slab dequantized energies
    qtail: torch.Tensor      # (N, S) f32 dequantized suffix energies
    norms: torch.Tensor      # (N,) f32 squared norms of dequantized rows
    err: torch.Tensor        # (N,) f32 exact L2 quantization error per row
    slab: int
    dim: int

    @property
    def n_vectors(self) -> int:
        return self.vp.shape[0]

    @property
    def n_slabs(self) -> int:
        return self.ftail.shape[1]

    @property
    def nbytes(self) -> int:
        return arrays_nbytes(self.perm, self.vp, self.ftail, self.q,
                             self.scales, self.qslab, self.qtail,
                             self.norms, self.err)


@dataclasses.dataclass(frozen=True)
class PdxQueries:
    """Queries encoded on a PdxStore's permutation + slab grid."""
    vp: torch.Tensor         # (B, S·slab) f32 permuted, padded queries
    ftail: torch.Tensor      # (B, S) f32 suffix energies
    q: torch.Tensor          # (B, S·slab) int8 codes
    qslab: torch.Tensor      # (B, S) f32 per-slab dequantized energies
    qtail: torch.Tensor      # (B, S) f32 dequantized suffix energies
    norms: torch.Tensor      # (B,) f32 dequantized squared norms
    err: torch.Tensor        # (B,) f32 exact per-query L2 error


def pdx_permutation(vecs, scale_rows=None) -> np.ndarray:
    """Variance-descending dimension order (stable ties). ``scale_rows``
    masks which rows contribute."""
    v = np.asarray(vecs, np.float32)
    if scale_rows is not None:
        scale_rows = np.asarray(scale_rows, bool)
        if scale_rows.any():
            v = v[np.flatnonzero(scale_rows)]
    var = v.var(axis=0) if v.shape[0] else np.zeros(v.shape[1], np.float32)
    return np.argsort(-var, kind="stable").astype(np.int32)


def _suffix(e: torch.Tensor) -> torch.Tensor:
    """Reversed cumulative sum along slabs (monotone nonincreasing)."""
    return torch.flip(torch.cumsum(torch.flip(e, [1]), dim=1), [1])


def _encode(x: torch.Tensor, perm: torch.Tensor, scales: torch.Tensor, *,
            slab: int):
    """Permute → pad → slab energies and suffix tables → int8 codes on the
    per-slab grid."""
    x = x.float()
    S = scales.shape[0]
    xp = x[:, perm.long()]
    pad = S * slab - x.shape[1]
    if pad:
        xp = torch.nn.functional.pad(xp, (0, pad))
    eslab = torch.sum((xp * xp).reshape(xp.shape[0], S, slab), dim=2)
    ftail = _suffix(eslab)
    sd = torch.repeat_interleave(scales, slab)
    q, norms, err = quantize_on_grid(xp, sd)
    deq = q.float() * sd
    qslab = torch.sum((deq * deq).reshape(deq.shape[0], S, slab), dim=2)
    qtail = _suffix(qslab)
    return xp.contiguous(), ftail, q, qslab, qtail, norms, err


def build_pdx(vecs, *, slab: int = DEFAULT_SLAB, scale_rows=None,
              device=None) -> PdxStore:
    """Build the PDX artifact for a vector table (offline phase).

    ``vecs`` is a tensor (kept on its device) or an array (placed on
    ``device``, the card when ``None``). The permutation and the per-slab scales come from the
    reference's numpy code on the host; ``scale_rows`` masks which rows
    set them (every row is encoded)."""
    from repro_torch.core.types import resolve_device
    if isinstance(vecs, torch.Tensor):
        vt = vecs.float()
    else:
        vt = torch.as_tensor(np.asarray(vecs, np.float32),
                             device=resolve_device(device))
    v = vt.cpu().numpy()
    d = v.shape[1]
    S = n_slabs(d, slab)
    perm = pdx_permutation(v, scale_rows)
    src = v
    if scale_rows is not None:
        sr = np.asarray(scale_rows, bool)
        if sr.any():
            src = v[np.flatnonzero(sr)]
    sp = src[:, perm]
    pad = S * slab - d
    if pad:
        sp = np.pad(sp, ((0, 0), (0, pad)))
    grouped = sp.reshape(sp.shape[0] if sp.shape[0] else 0, S, slab)
    scales = np.maximum(
        np.max(np.abs(grouped), axis=(0, 2), initial=0.0) / 127.0,
        _EPS).astype(np.float32)
    dev = vt.device
    perm_t = torch.as_tensor(perm, device=dev)
    scales_t = torch.as_tensor(scales, device=dev)
    vp, ftail, q, qslab, qtail, norms, err = _encode(vt, perm_t, scales_t,
                                                     slab=slab)
    return PdxStore(perm=perm_t, vp=vp, ftail=ftail, q=q, scales=scales_t,
                    qslab=qslab, qtail=qtail, norms=norms, err=err,
                    slab=slab, dim=d)


def pdx_store_from_numpy(perm, vp, ftail, q, scales, qslab, qtail, norms,
                         err, slab: int, dim: int, device) -> PdxStore:
    """Copy a PDX store given as numpy arrays (for example one built by
    the reference package) onto ``device`` unchanged."""
    dev = torch.device(device)

    def t(a, dt):
        return torch.tensor(np.asarray(a, dt), device=dev)
    return PdxStore(perm=t(perm, np.int32), vp=t(vp, np.float32),
                    ftail=t(ftail, np.float32), q=t(q, np.int8),
                    scales=t(scales, np.float32), qslab=t(qslab, np.float32),
                    qtail=t(qtail, np.float32), norms=t(norms, np.float32),
                    err=t(err, np.float32), slab=int(slab), dim=int(dim))


def pdx_queries(x: torch.Tensor, store: PdxStore) -> PdxQueries:
    """Encode queries on the store's permutation + slab grid."""
    vp, ftail, q, qslab, qtail, norms, err = _encode(
        x, store.perm, store.scales, slab=store.slab)
    return PdxQueries(vp=vp, ftail=ftail, q=q, qslab=qslab, qtail=qtail,
                      norms=norms, err=err)
