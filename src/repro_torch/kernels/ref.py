"""Plain PyTorch versions of the distance kernels (port of ``repro.kernels.ref``).

These are the semantic ground truth for the CUDA kernels in
``csrc/distance.cu`` and the path ``kernels.ops`` takes for tensors on the
CPU. The formulas are the reference's: the matmul form clamped at 0 for
pairwise distances, the difference form for per-query rows.
"""
from __future__ import annotations

import torch


def sq_norms(a: torch.Tensor) -> torch.Tensor:
    """(n, d) → (n,) f32 squared row norms (the pairwise epilogue's inputs)."""
    a = a.float()
    return torch.sum(a * a, dim=-1)


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, d) × (N, d) → (B, N) f32 ``max(‖x‖² + ‖y‖² − 2·x·yᵀ, 0)``."""
    x = x.float()
    y = y.float()
    xn = sq_norms(x)[:, None]
    yn = sq_norms(y)[None, :]
    d = xn + yn - 2.0 * (x @ y.T)
    return torch.clamp_min(d, 0.0)


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
    then to the lower candidate slot, as ``jnp.argsort`` orders them."""
    L = beam_dist.shape[-1]
    alld = torch.cat([beam_dist, cand_dist], dim=-1)
    alli = torch.cat([beam_idx, cand_idx.to(beam_idx.dtype)], dim=-1)
    alld, order = torch.sort(alld, dim=-1, stable=True)
    alli = torch.gather(alli, -1, order)
    return alld[:, :L], alli[:, :L]


__all__ = ["sq_norms", "pairwise_sq_dists", "rowwise_sq_dists",
           "gather_sq_dists", "topk_merge"]
