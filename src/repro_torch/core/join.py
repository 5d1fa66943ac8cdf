"""The exact nested-loop join (port of ``repro.core.join.cascade_join_pairs``
and ``exact_join_pairs``), without a cascade or through any tier chain.

The match mask of each query block is computed and compacted with
``nonzero`` on the device, so a (block, |Y|) matrix never crosses to the
host; only the matched (query, data) ids do. Through a cascade, tier 0
sweeps its codes pairwise against all of Y on certified bounds (the PDX
tier with mid-vector early exit against θ itself). With one tier that has
upper bounds (sq8, pdx8) pairs whose upper bound is below θ² are emitted
as they are; otherwise the survivors ``lb < θ²`` escalate pair by pair
through the later tiers (``pair_refine``: the running maximum of lower
bounds, the last tier's upper bound), in device-resident pair blocks. The
final ambiguous band is re-ranked exactly in difference form by the f32
gather kernel's pair-list entry, which reads each pair's query row in
place. The emitted order is per block:
certified pairs, then re-ranked ones (the reference's order differs; the
set is the same).
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


def _pairs(qi: torch.Tensor, yi: torch.Tensor, q0: int) -> torch.Tensor:
    return torch.stack([qi + q0, yi], dim=1)


def cascade_join_pairs(X, Y, theta: float, cascade=None, *, block: int = 512,
                       pair_block: int = 1 << 22, impl: str | None = None,
                       device=None, early_exit: bool = True
                       ) -> tuple[np.ndarray, dict]:
    """Exact NLJ: every (query, data) pair with L2 distance < θ, as (P, 2)
    int64, plus the reference's counts: ``escalated`` has one entry per
    tier after the first (the pairs that tier evaluated), ``n_rerank`` the
    f32 band evaluations, ``dims_scanned`` / ``dims_total`` the dimensions
    an early-exitable tier 0 (PDX) scanned and would scan in full.
    Retirement is certified, so pairs and every other count are the same
    with ``early_exit`` on and off. ``pair_block`` bounds the escalated
    pairs held at once (device memory, not results). Without a cascade
    the pairs are in row-major order."""
    if device is None and isinstance(Y, torch.Tensor):
        device = Y.device
    else:
        device = resolve_device(device)
    Y = _as_f32(Y, device)
    X = _as_f32(X, Y.device)
    th2 = sq_theta(theta)
    tiers = tuple(cascade.tiers) if cascade is not None else ()
    counts = {"escalated": [0] * max(len(tiers) - 1, 0), "n_rerank": 0,
              "dims_scanned": 0, "dims_total": 0}
    out = []
    for q0 in range(0, X.shape[0], block):
        q1 = min(q0 + block, X.shape[0])
        xb = X[q0:q1]
        if not tiers:
            mask = ops.pairwise_sq_dists(xb, Y, impl=impl) < th2
            hit = torch.nonzero(mask)
            hit[:, 0] += q0
            out.append(hit)
            continue
        t0 = tiers[0]
        qc0 = t0.encode(xb)
        if getattr(t0, "early_exitable", False):
            lb, ub, nscan = t0.pairwise_bounds_ee(
                qc0, theta=theta, early_exit=early_exit, impl=impl)
            # a lane scanned nscan·slab dims, clamped to dim: only a full
            # scan (nscan == S) reaches past dim, by S·slab − dim
            st0 = t0.store
            full = int((nscan == st0.n_slabs).sum())
            counts["dims_scanned"] += (
                st0.slab * int(nscan.sum())
                - (st0.n_slabs * st0.slab - st0.dim) * full)
            counts["dims_total"] += nscan.numel() * st0.dim
            del nscan
        else:
            lb, ub = t0.pairwise_bounds(qc0, impl=impl)
        if ub is not None and len(tiers) == 1:
            # one tier with upper bounds: certified-sure pairs straight
            # from the sweep (the sq8 / pdx8 fast path)
            sure = ub < th2
            out.append(_pairs(*torch.nonzero(sure, as_tuple=True), q0))
            qi, yi = torch.nonzero((lb < th2) & ~sure, as_tuple=True)
            del lb, ub, sure
            counts["n_rerank"] += int(qi.numel())
            out.append(_rerank_pairs(xb, Y, qi, yi, q0, th2, impl))
            continue
        qi, yi = torch.nonzero(lb < th2, as_tuple=True)
        plb_all = lb[qi, yi]
        del lb, ub
        if len(tiers) == 1:             # one tier without upper bounds
            counts["n_rerank"] += int(qi.numel())
            out.append(_rerank_pairs(xb, Y, qi, yi, q0, th2, impl))
            continue
        if not qi.numel():
            continue
        qcs = [t.encode(xb) for t in tiers[1:]]
        for p0 in range(0, qi.numel(), pair_block):
            out.extend(escalate_block(
                tiers[1:], qcs, xb, Y, qi[p0:p0 + pair_block],
                yi[p0:p0 + pair_block], plb_all[p0:p0 + pair_block], q0,
                th2, impl, counts))
    counts["escalated"] = tuple(counts["escalated"])
    if not out:
        return np.empty((0, 2), np.int64), counts
    return torch.cat(out).cpu().numpy().astype(np.int64), counts


def escalate_block(tiers, qcs, xb: torch.Tensor, Y: torch.Tensor,
                   qp: torch.Tensor, yp: torch.Tensor, plb: torch.Tensor,
                   q0: int, th2: float, impl: str | None,
                   counts: dict) -> list[torch.Tensor]:
    """One device-resident pair block of the escalation: each of ``tiers``
    (encoded queries ``qcs``) refines the pairs still kept, the running
    maximum of lower bounds from ``plb`` on, the last tier's upper bound;
    the certified-sure pairs are emitted and the ambiguous band re-ranked
    in f32. Adds to ``counts``; returns the block's (P', 2) pair tensors."""
    out = []
    pub = None
    keep = torch.ones_like(qp, dtype=torch.bool)
    for t, tier in enumerate(tiers):
        sel = torch.nonzero(keep, as_tuple=True)[0]
        counts["escalated"][t] += int(sel.numel())
        tlb, tub = tier.pair_refine(qcs[t], qp[sel], yp[sel])
        plb = plb.clone()
        plb[sel] = torch.maximum(plb[sel], tlb)
        if tub is not None:
            pub = torch.full_like(plb, float("inf"))
            pub[sel] = tub
        keep = keep & (plb < th2)
    if pub is not None:
        sure = keep & (pub < th2)
        out.append(_pairs(qp[sure], yp[sure], q0))
        amb = keep & ~sure
    else:
        amb = keep
    counts["n_rerank"] += int(amb.sum())
    out.append(_rerank_pairs(xb, Y, qp[amb], yp[amb], q0, th2, impl))
    return out


def _rerank_pairs(xb: torch.Tensor, Y: torch.Tensor, qi: torch.Tensor,
                  yi: torch.Tensor, q0: int, th2: float,
                  impl: str | None) -> torch.Tensor:
    """Exact f32 difference-form distances of explicit band pairs (the f32
    gather kernel's pair-list entry) → the (P', 2) pairs < θ²."""
    d = ops.gather_sq_dists_pairs(Y, xb, qi.to(torch.int32),
                                  yi.to(torch.int32), impl=impl)
    m = d < th2
    return _pairs(qi[m], yi[m], q0)


def exact_join_pairs(X, Y, theta: float, *, block: int = 512,
                     impl: str | None = None, device=None) -> np.ndarray:
    """All (query, data) pairs with L2 distance < θ — the ground truth."""
    pairs, _ = cascade_join_pairs(X, Y, theta, None, block=block, impl=impl,
                                  device=device)
    return pairs


# ---------------------------------------------------------------------------
# the one-shot wrapper over the engine
# ---------------------------------------------------------------------------

def vector_join(X, Y, cfg, *, index_y=None, index_x=None, index_merged=None,
                build_kw: dict | None = None, device=None):
    """Run the configured join method once (the paper's one-shot call):
    a transient ``JoinEngine`` over ``Y`` on ``device`` (the card when
    None) builds whatever index the method needs and is not supplied.
    Hold a ``repro_torch.engine.JoinEngine`` to reuse indexes across
    calls."""
    from repro_torch.engine import JoinEngine  # local: engine imports core

    eng = JoinEngine(Y, build_kw=build_kw, default=cfg, device=device)
    return eng.join(X, cfg, index_y=index_y, index_x=index_x,
                    index_merged=index_merged)
