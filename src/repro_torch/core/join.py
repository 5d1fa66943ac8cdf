"""The exact nested-loop join (port of ``repro.core.join.cascade_join_pairs``
and ``exact_join_pairs``), without a cascade or through an int8 one.

The match mask of each query block is computed and compacted with
``nonzero`` on the device, so a (block, |Y|) bool matrix never crosses to
the host; only the matched (query, data) ids do. Under the sq8 cascade
(one int8 tier) the sweep runs on certified bounds from the int8 pairwise
kernel: pairs whose upper bound is below θ² are emitted as they are, the
ambiguous band ``lb < θ² ≤ ub`` is split off on the device and re-ranked
exactly in difference form by the f32 gather kernel, one (P, 1) id column.
The emitted order is per block: certified pairs, then re-ranked ones.
Cascades of more than one tier (sketch8, pdx8) arrive with their slices.
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
    int64, plus the reference's per-tier counts (``n_rerank`` = pairs
    re-ranked in f32; ``escalated`` empty for one tier). Without a cascade
    the pairs are in row-major order."""
    if cascade is not None and cascade.names != ("int8",):
        raise NotImplementedError(
            f"cascade {cascade.names}: only the sq8 int8 tier is ported; "
            f"sketch and PDX tiers arrive with ROADMAP Queue A slices 8-9")
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
    tier = cascade.final if cascade is not None else None
    for q0 in range(0, X.shape[0], block):
        q1 = min(q0 + block, X.shape[0])
        if tier is None:
            mask = ops.pairwise_sq_dists(X[q0:q1], Y, impl=impl) < th2
            hit = torch.nonzero(mask)
            hit[:, 0] += q0
            out.append(hit)
            continue
        xb = X[q0:q1]
        lb, ub = tier.pairwise_bounds(tier.encode(xb), impl=impl)
        sure = ub < th2
        hit = torch.nonzero(sure)
        hit[:, 0] += q0
        out.append(hit)
        qi, yi = torch.nonzero((lb < th2) & ~sure, as_tuple=True)
        del lb, ub, sure
        counts["n_rerank"] += int(qi.numel())
        out.append(_rerank_pairs(xb, Y, qi, yi, q0, th2, impl))
    if not out:
        return np.empty((0, 2), np.int64), counts
    return torch.cat(out).cpu().numpy().astype(np.int64), counts


def _rerank_pairs(xb: torch.Tensor, Y: torch.Tensor, qi: torch.Tensor,
                  yi: torch.Tensor, q0: int, th2: float,
                  impl: str | None) -> torch.Tensor:
    """Exact f32 difference-form distances of explicit band pairs (the f32
    gather kernel over a (P, 1) id column) → the (P', 2) pairs < θ²."""
    d = ops.gather_sq_dists(Y, xb[qi].contiguous(),
                            yi.to(torch.int32)[:, None].contiguous(),
                            impl=impl)[:, 0]
    m = d < th2
    return torch.stack([qi[m] + q0, yi[m]], dim=1)


def exact_join_pairs(X, Y, theta: float, *, block: int = 512,
                     impl: str | None = None, device=None) -> np.ndarray:
    """All (query, data) pairs with L2 distance < θ — the ground truth."""
    pairs, _ = cascade_join_pairs(X, Y, theta, None, block=block, impl=impl,
                                  device=device)
    return pairs
