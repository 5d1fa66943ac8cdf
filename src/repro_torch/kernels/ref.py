"""Plain PyTorch versions of the distance kernels (port of ``repro.kernels.ref``).

These are the semantic ground truth for the CUDA kernels in ``csrc/*.cu``
and the path ``kernels.ops`` takes for tensors on the CPU. The formulas are
the reference's: the matmul form clamped at 0 for pairwise distances, the
difference form for per-query rows; the int8 versions dequantize first and
then take the f32 form, so they round differently from the kernels, which
stay in the integer domain per dimension group.
"""
from __future__ import annotations

import torch


def sq_norms(a: torch.Tensor) -> torch.Tensor:
    """(n, d) → (n,) f32 squared row norms (the pairwise epilogue's inputs)."""
    a = a.float()
    return torch.sum(a * a, dim=-1)


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor,
                      xn: torch.Tensor | None = None,
                      yn: torch.Tensor | None = None) -> torch.Tensor:
    """(B, d) × (N, d) → (B, N) f32 ``max(‖x‖² + ‖y‖² − 2·x·yᵀ, 0)``;
    ``xn``/``yn`` are the squared norms (computed here when omitted)."""
    x = x.float()
    y = y.float()
    xn = (sq_norms(x) if xn is None else xn)[:, None]
    yn = (sq_norms(y) if yn is None else yn)[None, :]
    d = xn + yn - 2.0 * (x @ y.T)
    return torch.clamp_min(d, 0.0)


def pairlist_sq_dists(x: torch.Tensor, y: torch.Tensor, xn: torch.Tensor,
                      yn: torch.Tensor, qi: torch.Tensor,
                      yi: torch.Tensor) -> torch.Tensor:
    """(P,) f32 matmul-form distances of explicit pairs (x[qi], y[yi]),
    ``max(xn[qi] + yn[yi] − 2·x[qi]·y[yi], 0)``; a pair with an id out of
    range gives +inf."""
    ok = (qi >= 0) & (qi < x.shape[0]) & (yi >= 0) & (yi < y.shape[0])
    q = torch.where(ok, qi, 0).long()
    j = torch.where(ok, yi, 0).long()
    dot = torch.sum(x[q].float() * y[j].float(), dim=-1)
    d = torch.clamp_min(xn[q] + yn[j] - 2.0 * dot, 0.0)
    return torch.where(ok, d, torch.inf)


def rowwise_sq_dists(x: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """(B, d) × (B, K, d) → (B, K) f32 difference-form ``Σ (c − x)²``."""
    diff = cands.float() - x.float()[:, None, :]
    return torch.sum(diff * diff, dim=-1)


def gather_sq_dists(vecs: torch.Tensor, x: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    """(N, d) vecs × (B, d) x × (B, K) ids → (B, K) f32 squared distances
    ``rowwise_sq_dists(x, vecs[idx])``; ids outside [0, N) (NO_NODE) give
    +inf."""
    valid = (idx >= 0) & (idx < vecs.shape[0])
    safe = torch.where(valid, idx, 0).long()
    d = rowwise_sq_dists(x, vecs[safe])
    return torch.where(valid, d, torch.inf)


def topk_merge(beam_dist: torch.Tensor, beam_idx: torch.Tensor,
               cand_dist: torch.Tensor, cand_idx: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge a sorted (B, L) beam with (B, K) candidates; keep the L
    smallest, ascending. The sort is stable, so ties go to the beam and
    then to the lower candidate slot, as ``jnp.argsort`` orders them.
    Slots holding +inf come back with the id NO_NODE (-1), as the
    reference's Pallas kernel returns its empty slots."""
    L = beam_dist.shape[-1]
    alld = torch.cat([beam_dist, cand_dist], dim=-1)
    alli = torch.cat([beam_idx, cand_idx.to(beam_idx.dtype)], dim=-1)
    alld, order = torch.sort(alld, dim=-1, stable=True)
    alli = torch.gather(alli, -1, order)
    od, oi = alld[:, :L], alli[:, :L]
    return od, torch.where(od == torch.inf, -1, oi).to(beam_idx.dtype)


# ---------------------------------------------------------------------------
# int8 (QuantStore codes): dequantize, then the f32 forms
# ---------------------------------------------------------------------------

def _dequant(q: torch.Tensor, scales: torch.Tensor,
             group_size: int) -> torch.Tensor:
    from repro_torch.quant.store import dequantize
    return dequantize(q, scales, group_size)


def pairwise_sq_dists_int8(qx: torch.Tensor, qy: torch.Tensor,
                           scales: torch.Tensor, *,
                           group_size: int = 128) -> torch.Tensor:
    """Quantized-domain pairwise squared L2 ``‖x̂ − ŷ‖²`` via dequantize."""
    return pairwise_sq_dists(_dequant(qx, scales, group_size),
                             _dequant(qy, scales, group_size))


def rowwise_sq_dists_int8(qx: torch.Tensor, qcands: torch.Tensor,
                          scales: torch.Tensor, *,
                          group_size: int = 128) -> torch.Tensor:
    """Quantized-domain rowwise squared L2 over (B, K, d) candidates."""
    return rowwise_sq_dists(_dequant(qx, scales, group_size),
                            _dequant(qcands, scales, group_size))


def gather_sq_dists_int8(codes: torch.Tensor, qx: torch.Tensor,
                         idx: torch.Tensor, scales: torch.Tensor, *,
                         group_size: int = 128) -> torch.Tensor:
    """``rowwise_sq_dists_int8(qx, codes[idx])``; ids outside [0, N)
    (NO_NODE) give +inf."""
    valid = (idx >= 0) & (idx < codes.shape[0])
    safe = torch.where(valid, idx, 0).long()
    d = rowwise_sq_dists_int8(qx, codes[safe], scales, group_size=group_size)
    return torch.where(valid, d, torch.inf)


__all__ = ["sq_norms", "pairwise_sq_dists", "pairlist_sq_dists",
           "rowwise_sq_dists", "gather_sq_dists", "topk_merge",
           "pairwise_sq_dists_int8", "rowwise_sq_dists_int8",
           "gather_sq_dists_int8"]
