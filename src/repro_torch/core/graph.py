"""Offline graph-index construction (paper §4.4, NSG style), in PyTorch.

Port of ``repro.core.graph`` (f32 builds; the cascade-driven ``quant=``
builds are a later slice). The pipeline is the reference's:

  1. exact kNN graph — blocked pairwise distances (``kernels.ops``, the
     CUDA pairwise kernel on the card) with a running top-k merge;
  2. RNG/MRNG edge pruning (paper Fig. 5);
  3. medoid navigating node;
  4. reverse edges and connectivity repair (nodes unreachable from the
     medoid are attached to their nearest reachable node);
  5. the ``mean_nbr_dist`` side table of the OOD predictor.

Every step runs on the index's device. The reference runs step 4 on the
host in Python loops; here the reverse-edge insertion is vectorized with
the same result (see ``_add_reverse_edges``), since a loop over a
million nodes would dominate the build.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import NO_NODE, GraphIndex, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import ref as _ref

_INF = float("inf")


def _as_vecs(vecs, device) -> torch.Tensor:
    if isinstance(vecs, torch.Tensor):
        dev = vecs.device if device is None else torch.device(device)
        return vecs.to(device=dev, dtype=torch.float32).contiguous()
    dev = resolve_device(device)
    return torch.as_tensor(np.asarray(vecs, np.float32), device=dev)


# ---------------------------------------------------------------------------
# 1. exact kNN graph (blocked)
# ---------------------------------------------------------------------------

def _knn_block(qvecs: torch.Tensor, vecs: torch.Tensor, qoff: int, *, k: int,
               dblock: int, impl: str | None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """kNN of a query block against all vecs (excluding self).

    Equals the reference's stable merge over data blocks: the k smallest
    by (distance, id). Each data block is first cut to its own k smallest
    with ``torch.topk`` (put back in id order) before the stable merge, so
    the merge sorts 2k entries instead of k + dblock; only which of several
    entries tied at exactly the k-th distance survives can differ."""
    dev = vecs.device
    n = vecs.shape[0]
    bq = qvecs.shape[0]
    bd = torch.full((bq, k), _INF, device=dev)
    bi = torch.full((bq, k), NO_NODE, dtype=torch.int32, device=dev)
    self_ids = qoff + torch.arange(bq, device=dev)
    for j0 in range(0, n, dblock):
        j1 = min(j0 + dblock, n)
        d = ops.pairwise_sq_dists(qvecs, vecs[j0:j1], impl=impl)
        loc = self_ids - j0
        inblk = (loc >= 0) & (loc < j1 - j0)
        if bool(inblk.any()):
            rows = torch.nonzero(inblk).squeeze(1)
            d[rows, loc[rows]] = _INF
        if j1 - j0 > k:
            _, pos = torch.topk(d, k, dim=1, largest=False, sorted=False)
            pos, _ = torch.sort(pos, dim=1)
            d = torch.gather(d, 1, pos)
            ids = (pos + j0).to(torch.int32)
        else:
            ids = (j0 + torch.arange(j1 - j0, device=dev, dtype=torch.int32)
                   ).expand(bq, -1)
        bd, bi = _ref.topk_merge(bd, bi, d, ids)
    return bd, bi


def exact_knn(vecs, k: int, *, qblock: int = 4096, dblock: int = 65536,
              impl: str | None = None, device=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN graph: (dists (N,k) f32, ids (N,k) int32), ascending."""
    vecs = _as_vecs(vecs, device)
    n = vecs.shape[0]
    out_d = torch.empty((n, k), dtype=torch.float32, device=vecs.device)
    out_i = torch.empty((n, k), dtype=torch.int32, device=vecs.device)
    for q0 in range(0, n, qblock):
        q1 = min(q0 + qblock, n)
        out_d[q0:q1], out_i[q0:q1] = _knn_block(
            vecs[q0:q1], vecs, q0, k=k, dblock=dblock, impl=impl)
    return out_d, out_i


# ---------------------------------------------------------------------------
# 2. RNG / MRNG pruning (paper Fig. 5)
# ---------------------------------------------------------------------------

def _prune_from_lt(lt: torch.Tensor, valid: torch.Tensor,
                   cand_ids: torch.Tensor, R: int) -> torch.Tensor:
    """The Fig. 5 keep loop given ``lt[b, w, v] = dist(w, v) < dist(u, v)``:
    walking candidates in ascending distance, keep v iff no kept w beats
    it, at most R; kept ids are compacted left in order."""
    b, k = cand_ids.shape
    keep = torch.zeros((b, k), dtype=torch.bool, device=cand_ids.device)
    kept = torch.zeros((b,), dtype=torch.int64, device=cand_ids.device)
    for i in range(k):
        conflict = torch.any(keep & lt[:, :, i], dim=1)
        ok = valid[:, i] & ~conflict & (kept < R)
        keep[:, i] = ok
        kept += ok
    pos = torch.cumsum(keep, dim=1) - 1
    pos = torch.where(keep, pos, R)                          # dump to column R
    out = torch.full((b, R + 1), NO_NODE, dtype=torch.int32,
                     device=cand_ids.device)
    out.scatter_(1, pos, torch.where(keep, cand_ids, NO_NODE))
    return out[:, :R]


def _pair_sq_dists(cvecs: torch.Tensor) -> torch.Tensor:
    """(b, k, d) gathered candidate rows → (b, k, k) matmul-form pairwise
    squared distances (full f32 batched product)."""
    c = cvecs.float()
    cn = torch.sum(c * c, dim=-1)
    cc = torch.bmm(c, c.transpose(1, 2))
    return torch.clamp_min(cn[:, :, None] + cn[:, None, :] - 2.0 * cc, 0.0)


def _rng_prune_block(vecs: torch.Tensor, cand_ids: torch.Tensor,
                     cand_d: torch.Tensor, *, R: int) -> torch.Tensor:
    """Prune candidate lists (ascending by distance) to RNG edges, max R."""
    pair = _pair_sq_dists(vecs[cand_ids.clamp_min(0).long()])
    valid = cand_ids != NO_NODE
    return _prune_from_lt(pair < cand_d[:, None, :], valid, cand_ids, R)


# ---------------------------------------------------------------------------
# 3.+4. medoid & connectivity repair
# ---------------------------------------------------------------------------

def _medoid(vecs: torch.Tensor, sample: int = 4096, seed: int = 0) -> int:
    n = vecs.shape[0]
    rng = np.random.default_rng(seed)          # the reference's sample
    idx = rng.choice(n, size=min(sample, n), replace=False)
    sub = vecs[torch.as_tensor(idx, device=vecs.device)]
    d = ops.pairwise_sq_dists(sub, sub)
    return int(idx[int(np.argmin(torch.sum(d, dim=1).cpu().numpy()))])


def _reachable(nbrs: torch.Tensor, start: int) -> torch.Tensor:
    """BFS reachability over the dense neighbor table → (N,) bool."""
    n = nbrs.shape[0]
    seen = torch.zeros(n, dtype=torch.bool, device=nbrs.device)
    seen[start] = True
    frontier = torch.tensor([start], device=nbrs.device)
    while frontier.numel():
        nxt = nbrs[frontier].reshape(-1).long()
        nxt = nxt[nxt >= 0]
        nxt = nxt[~seen[nxt]]
        if nxt.numel() == 0:
            break
        nxt = torch.unique(nxt)
        seen[nxt] = True
        frontier = nxt
    return seen


def _add_reverse_edges(nbrs: torch.Tensor, chunk: int = 1 << 22
                       ) -> torch.Tensor:
    """Insert backward edges into free slots (NSG post-pruning step), in
    place.

    The reference walks the nodes v in order and, for each edge u→v taken
    from the table as it was on entry (u ascending), writes u into v's next
    free slot unless u is already in v's row. Rows hold distinct ids and
    only row v changes while v is processed, so that equals: drop the edges
    whose u is already in v's original row, rank the rest per v by u, and
    put rank r into v's r-th free slot while r < free slots — computed here
    for all edges at once."""
    n, R = nbrs.shape
    dev = nbrs.device
    u = torch.arange(n, device=dev).repeat_interleave(R)
    v = nbrs.reshape(-1).long()
    ok = v >= 0
    u, v = u[ok], v[ok]
    v, order = torch.sort(v, stable=True)
    u = u[order]
    present = torch.empty(v.numel(), dtype=torch.bool, device=dev)
    for e0 in range(0, v.numel(), chunk):
        e1 = min(e0 + chunk, v.numel())
        present[e0:e1] = torch.any(nbrs[v[e0:e1]] == u[e0:e1, None], dim=1)
    u, v = u[~present], v[~present]
    first = torch.searchsorted(v, v)                   # group start of each v
    rank = torch.arange(v.numel(), device=dev) - first
    free = nbrs == NO_NODE
    sel = rank < free.sum(dim=1)[v]
    u, v, rank = u[sel], v[sel], rank[sel]
    # column of each row's r-th free slot: free columns first, in order
    free_cols = torch.sort((~free).to(torch.int8), dim=1, stable=True)[1]
    nbrs[v, free_cols[v, rank]] = u.to(nbrs.dtype)
    return nbrs


def _repair_connectivity(vecs: torch.Tensor, nbrs: torch.Tensor, start: int,
                         impl: str | None, block: int = 256) -> torch.Tensor:
    """Attach unreachable nodes to their nearest reachable node (NSG
    tree-span), in place."""
    n, R = nbrs.shape
    for _ in range(64):  # bounded repair rounds
        seen = _reachable(nbrs, start)
        missing = torch.nonzero(~seen).squeeze(1)
        if missing.numel() == 0:
            break
        reach_ids = torch.nonzero(seen).squeeze(1)
        rv = vecs[reach_ids]
        host = torch.empty_like(missing)
        for m0 in range(0, missing.numel(), block):
            m1 = min(m0 + block, missing.numel())
            d = ops.pairwise_sq_dists(vecs[missing[m0:m1]], rv, impl=impl)
            host[m0:m1] = reach_ids[torch.argmin(d, dim=1)]
        # sequential attach, as the reference does: several missing nodes
        # may share a host row (only the touched rows go to the host)
        missing_np, host_np = missing.cpu().numpy(), host.cpu().numpy()
        hosts = np.unique(host_np)
        rows = nbrs[torch.as_tensor(hosts, device=nbrs.device)].cpu().numpy()
        slot = {int(h): i for i, h in enumerate(hosts)}
        for m, h in zip(missing_np, host_np):
            row = rows[slot[int(h)]]
            free = np.flatnonzero(row == NO_NODE)
            if free.size:
                row[free[0]] = m
            else:
                row[R - 1] = m  # evict farthest edge (last slot)
        nbrs[torch.as_tensor(hosts, device=nbrs.device)] = torch.as_tensor(
            rows, device=nbrs.device)
    return nbrs


def _mean_nbr_dist(vecs: torch.Tensor, nbrs: torch.Tensor, impl: str | None,
                   block: int = 65536) -> torch.Tensor:
    """OOD side table (paper §4.5): mean L2 (not squared) neighbor distance.
    Row-blocked, so the gathered (block, R, d) rows stay small."""
    n = nbrs.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=vecs.device)
    for b0 in range(0, n, block):
        b1 = min(b0 + block, n)
        nb = nbrs[b0:b1]
        nvecs = vecs[nb.clamp_min(0).long()]
        nd = torch.sqrt(ops.rowwise_sq_dists(vecs[b0:b1], nvecs, impl=impl))
        mask = nb != NO_NODE
        out[b0:b1] = (torch.sum(torch.where(mask, nd, 0.0), dim=1)
                      / torch.sum(mask, dim=1).clamp_min(1))
    return out


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def build_index(vecs, *, k: int = 48, degree: int = 32,
                n_data: int | None = None, prune_block: int = 16384,
                seed: int = 0, impl: str | None = None, style: str = "nsg",
                quant: str | None = None, device=None) -> GraphIndex:
    """Build a graph index over ``vecs`` (see ``repro.core.graph.build_index``).

    ``vecs`` is a tensor (kept on its device unless ``device`` is given) or
    an array (placed on ``device``; ``None`` means the CUDA card).
    """
    if quant is not None and quant != "off":
        raise NotImplementedError(
            "cascade-driven index builds (quant=) arrive with the sq8 slice "
            "(ROADMAP Queue A slice 7)")
    if style not in ("nsg", "nsw"):
        raise ValueError(f"unknown style {style!r}")
    vecs = _as_vecs(vecs, device)
    n = vecs.shape[0]
    k = min(k, n - 1)
    cand_d, cand_i = exact_knn(vecs, k, impl=impl)
    if style == "nsw":
        half = max(degree // 2, 1)   # leave slots for reverse edges
        nbrs = torch.full((n, degree), NO_NODE, dtype=torch.int32,
                          device=vecs.device)
        nbrs[:, :half] = cand_i[:, :half]
    else:
        nbrs = torch.empty((n, degree), dtype=torch.int32, device=vecs.device)
        for b0 in range(0, n, prune_block):
            b1 = min(b0 + prune_block, n)
            nbrs[b0:b1] = _rng_prune_block(vecs, cand_i[b0:b1],
                                           cand_d[b0:b1], R=degree)
    del cand_d, cand_i
    start = _medoid(vecs, seed=seed)
    nbrs = _add_reverse_edges(nbrs)
    nbrs = _repair_connectivity(vecs, nbrs, start, impl)
    nbrs = _add_reverse_edges(nbrs)  # make repair spokes two-way as well
    mnd = _mean_nbr_dist(vecs, nbrs, impl)
    return GraphIndex(vecs=vecs, nbrs=nbrs,
                      start=torch.tensor(start, dtype=torch.int32,
                                         device=vecs.device),
                      mean_nbr_dist=mnd,
                      n_data=int(n if n_data is None else n_data))


def build_merged_index(Y, X, *, device=None, **kw) -> GraphIndex:
    """Merged index G_{X∪Y} (paper §4.4): data ids [0,|Y|), query ids after."""
    Y = _as_vecs(Y, device)
    X = _as_vecs(X, Y.device)
    return build_index(torch.cat([Y, X], dim=0), n_data=Y.shape[0], **kw)
