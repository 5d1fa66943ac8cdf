"""The exact nested-loop join (port of the no-cascade branch of
``repro.core.join.cascade_join_pairs`` and ``exact_join_pairs``).

The match mask of each query block is computed and compacted with
``nonzero`` on the device, so a (block, |Y|) bool matrix never crosses to
the host; only the matched (query, data) ids do. The filter-then-rerank
cascade path arrives with the sq8 slice (ROADMAP Queue A slice 7).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.traversal import sq_theta
from repro_torch.core.types import resolve_device
from repro_torch.kernels import ops


def _as_f32(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32).contiguous()
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def cascade_join_pairs(X, Y, theta: float, cascade=None, *, block: int = 512,
                       impl: str | None = None, device=None
                       ) -> tuple[np.ndarray, dict]:
    """Exact NLJ: every (query, data) pair with L2 distance < θ, as (P, 2)
    int64 in row-major order, plus the reference's per-tier counts (all
    empty without a cascade)."""
    if cascade is not None:
        raise NotImplementedError(
            "FilterCascade joins arrive with the sq8 slice "
            "(ROADMAP Queue A slice 7)")
    if device is None and isinstance(Y, torch.Tensor):
        device = Y.device
    else:
        device = resolve_device(device)
    Y = _as_f32(Y, device)
    X = _as_f32(X, Y.device)
    th2 = sq_theta(theta)
    counts = {"escalated": (), "n_rerank": 0, "dims_scanned": 0,
              "dims_total": 0}
    out = []
    for q0 in range(0, X.shape[0], block):
        q1 = min(q0 + block, X.shape[0])
        mask = ops.pairwise_sq_dists(X[q0:q1], Y, impl=impl) < th2
        hit = torch.nonzero(mask)
        hit[:, 0] += q0
        out.append(hit)
    if not out:
        return np.empty((0, 2), np.int64), counts
    return torch.cat(out).cpu().numpy().astype(np.int64), counts


def exact_join_pairs(X, Y, theta: float, *, block: int = 512,
                     impl: str | None = None, device=None) -> np.ndarray:
    """All (query, data) pairs with L2 distance < θ — the ground truth."""
    pairs, _ = cascade_join_pairs(X, Y, theta, None, block=block, impl=impl,
                                  device=device)
    return pairs
