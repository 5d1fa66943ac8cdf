"""Out-of-distribution query prediction (paper §4.5, Fig. 7).

Port of ``repro.core.ood``. A query is predicted OOD when the mean L2
distance d1 from the query to its neighboring *data* points (its row in
the merged index) exceeds ``factor``× the mean distance d2 from those
neighbors to *their* neighbors, read from the ``mean_nbr_dist`` side table.

d1 goes through the gather kernel: it reads each neighbor row by id, so
the (B, R, d) gathered tensor is never built; non-data slots pass NO_NODE,
read no row, and are masked out as the reference masks them.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import NO_NODE, GraphIndex
from repro_torch.kernels import ops


def predict_ood(merged: GraphIndex, x: torch.Tensor, qids: torch.Tensor, *,
                factor: float = 1.5, impl: str | None = None) -> torch.Tensor:
    """(B,) bool OOD flags for queries ``x`` whose merged-index node ids
    are ``qids`` (≥ n_data). True ⇒ use the hybrid BBFS."""
    rows = merged.nbrs[qids.long()]                              # (B, R)
    is_data = (rows != NO_NODE) & (rows < merged.n_data)
    d1_all = torch.sqrt(ops.gather_sq_dists(
        merged.vecs, x, torch.where(is_data, rows, NO_NODE), impl=impl))
    n_data_nbrs = torch.sum(is_data, dim=1)
    cnt = n_data_nbrs.clamp_min(1)
    d1 = torch.sum(torch.where(is_data, d1_all, 0.0), dim=1) / cnt
    d2_all = merged.mean_nbr_dist[rows.clamp_min(0).long()]
    d2 = torch.sum(torch.where(is_data, d2_all, 0.0), dim=1) / cnt
    # queries with no data neighbors at all are OOD by definition
    return (n_data_nbrs == 0) | (d1 > factor * d2)
