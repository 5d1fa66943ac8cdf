"""Offline graph-index construction (paper §4.4, NSG style), in PyTorch.

Port of ``repro.core.graph``, f32 and cascade-driven (``quant="sq8"``)
builds. The pipeline is the reference's:

  1. exact kNN graph — blocked pairwise distances (``kernels.ops``, the
     CUDA pairwise kernel on the card) with a running top-k merge (the
     CUDA top-k merge kernel);
  2. RNG/MRNG edge pruning (paper Fig. 5);
  3. medoid navigating node;
  4. reverse edges and connectivity repair (nodes unreachable from the
     medoid are attached to their nearest reachable node);
  5. the ``mean_nbr_dist`` side table of the OOD predictor.

Every step runs on the index's device. The reference runs step 4 on the
host in Python loops; here the reverse-edge insertion is vectorized with
the same result (see ``_add_reverse_edges``), since a loop over a
million nodes would dominate the build.

**Cascade-driven builds** (``build_index(..., quant="sq8")``): the kNN
sweep runs on the int8 tier's certified bounds (the CUDA int8 pairwise
kernel) and keeps, per row, only candidates whose lower bound beats the
k-th smallest upper bound plus a matmul-rounding margin — a certified
superset of the f32 top-k — in a fixed-width device buffer (a
``StickyCap`` that grows and retries); the survivors are re-ranked with
the pair-list entry of the f32 pairwise kernel, whose values equal the f32
sweep's bit for bit (same dot, same epilogue, same norm tensor). The RNG
prune resolves each comparison from bounds where they are decisive and
recomputes only the ambiguous band in f32. The neighbor lists equal the
f32 build's, up to which of several entries tied at exactly the k-th
distance survives (see ``_knn_block``). Nothing leaves the device;
``BuildStats`` reports the f32 traffic avoided.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.types import NO_NODE, GraphIndex, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import ref as _ref

_INF = float("inf")


@dataclasses.dataclass
class BuildStats:
    """Traffic accounting for one cascade-driven index build (the
    reference's fields): ``f32_bytes`` is what the build moved through
    f32 distance evaluations, ``f32_bytes_full`` what the plain f32 build
    would have moved for the same steps, ``tier_bytes`` the int8 traffic
    that replaced it; ``knn_pairs``/``knn_exact`` and ``prune_pairs``/
    ``prune_exact`` count pairs bounded vs pairs needing exact f32.
    Beyond the reference's: ``knn_blocks`` counts the kNN sweep's bound
    blocks (one (query block, data block) bounds call each, redone
    sweeps included) and ``knn_sweep_s`` their device seconds, taken
    with CUDA events around each query block's sweep (0 off the card).
    """
    knn_pairs: int = 0
    knn_exact: int = 0
    prune_pairs: int = 0
    prune_exact: int = 0
    f32_bytes: int = 0
    f32_bytes_full: int = 0
    tier_bytes: int = 0
    knn_blocks: int = 0
    knn_sweep_s: float = 0.0

    @property
    def f32_saved_frac(self) -> float:
        if self.f32_bytes_full == 0:
            return 0.0
        return 1.0 - self.f32_bytes / self.f32_bytes_full

    def as_dict(self) -> dict:
        return dict(dataclasses.asdict(self),
                    f32_saved_frac=self.f32_saved_frac)


def _as_vecs(vecs, device) -> torch.Tensor:
    if isinstance(vecs, torch.Tensor):
        dev = vecs.device if device is None else torch.device(device)
        return vecs.to(device=dev, dtype=torch.float32).contiguous()
    dev = resolve_device(device)
    return torch.as_tensor(np.asarray(vecs, np.float32), device=dev)


# ---------------------------------------------------------------------------
# 1. exact kNN graph (blocked)
# ---------------------------------------------------------------------------

def _exclude_self(d: torch.Tensor, q0: int, q1: int, j0: int,
                  j1: int) -> None:
    """Set the self-distance entries of a (query rows [q0,q1)) × (data
    rows [j0,j1)) block to +inf, in place."""
    lo, hi = max(q0, j0), min(q1, j1)
    if lo < hi:
        r = torch.arange(lo, hi, device=d.device)
        d[r - q0, r - j0] = _INF


def _cut_block(d: torch.Tensor, j0: int, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """A data block's own k smallest per row, back in id order (ties at
    the k-th value: whichever ``torch.topk`` keeps)."""
    bq, nb = d.shape
    if nb > k:
        _, pos = torch.topk(d, k, dim=1, largest=False, sorted=False)
        pos, _ = torch.sort(pos, dim=1)
        return torch.gather(d, 1, pos), (pos + j0).to(torch.int32)
    ids = j0 + torch.arange(nb, device=d.device, dtype=torch.int32)
    return d, ids.expand(bq, -1).contiguous()


def _knn_block(vecs: torch.Tensor, vn: torch.Tensor, q0: int, q1: int, *,
               k: int, dblock: int, impl: str | None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """kNN of query rows [q0, q1) of ``vecs`` against all rows (excluding
    self); ``vn`` holds every row's squared norm, passed to the kernel so
    that a pair-list re-rank reproduces these values.

    Equals the reference's stable merge over data blocks: the k smallest
    by (distance, id). Each data block is first cut to its own k smallest
    with ``torch.topk`` (put back in id order) before the stable merge, so
    the merge sorts 2k entries instead of k + dblock; only which of several
    entries tied at exactly the k-th distance survives can differ."""
    dev = vecs.device
    n = vecs.shape[0]
    bq = q1 - q0
    bd = torch.full((bq, k), _INF, device=dev)
    bi = torch.full((bq, k), NO_NODE, dtype=torch.int32, device=dev)
    for j0 in range(0, n, dblock):
        j1 = min(j0 + dblock, n)
        d = ops.pairwise_sq_dists(vecs[q0:q1], vecs[j0:j1], xn=vn[q0:q1],
                                  yn=vn[j0:j1], impl=impl)
        _exclude_self(d, q0, q1, j0, j1)
        bd, bi = ops.topk_merge(bd, bi, *_cut_block(d, j0, k), impl=impl)
    return bd, bi


def exact_knn(vecs, k: int, *, qblock: int = 4096, dblock: int = 65536,
              impl: str | None = None, device=None, cascade=None,
              stats: BuildStats | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN graph: (dists (N,k) f32, ids (N,k) int32), ascending.

    With a ``cascade`` that holds an int8 tier the sweep runs
    filter-then-rerank on the device (``_cascade_knn``): the same lists
    and distances, f32 traffic proportional to the survivor band."""
    vecs = _as_vecs(vecs, device)
    n = vecs.shape[0]
    vn = _ref.sq_norms(vecs)
    confirm = cascade.tier("int8") if cascade is not None else None
    if confirm is not None:
        return _cascade_knn(vecs, vn, confirm, k, qblock=qblock,
                            dblock=dblock, impl=impl, stats=stats)
    out_d = torch.empty((n, k), dtype=torch.float32, device=vecs.device)
    out_i = torch.empty((n, k), dtype=torch.int32, device=vecs.device)
    for q0 in range(0, n, qblock):
        q1 = min(q0 + qblock, n)
        out_d[q0:q1], out_i[q0:q1] = _knn_block(
            vecs, vn, q0, q1, k=k, dblock=dblock, impl=impl)
    return out_d, out_i


def _cascade_knn(vecs: torch.Tensor, vn: torch.Tensor, tier, k: int, *,
                 qblock: int, dblock: int, impl: str | None,
                 stats: BuildStats | None, init_cap: int = 1024
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """kNN through the cascade's int8 tier: certified filter, exact
    re-rank of the survivor band (``repro.core.graph._cascade_knn``).

    Soundness: with τ the k-th smallest certified upper bound of a row, at
    least k candidates lie within τ, and every member of the f32 top-k has
    lower bound ≤ τ + 2g (g the matmul-rounding guard), so the filter
    ``lb ≤ τ + margin`` (margin ≥ 2g) keeps a superset of the f32
    selection. Per query block, a running top-k of upper bounds (the
    top-k merge kernel after a per-block ``torch.topk`` cut) gives τ_run ≥
    τ; each data block appends its survivors ``lb ≤ τ_run + margin`` to a
    (rows, cap) device buffer and drops buffered entries the tighter
    τ_run excludes, keeping ids ascending within a row. A row whose
    survivors ever exceed the cap grows the sticky cap and redoes the
    block. The survivors against the final τ are re-ranked with the
    pair-list kernel and the k smallest by (distance, id) are kept."""
    from repro_torch.quant.cascade import MATMUL_GUARD

    st = tier.store
    n, d = vecs.shape
    dev = vecs.device
    out_d = torch.empty((n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n, k), dtype=torch.int32, device=dev)
    max_yn = float(st.norms.max()) if n else 0.0
    cap = ops.StickyCap(max(init_cap, k), max(n, 1))
    n_exact = torch.zeros((), dtype=torch.int64, device=dev)
    n_sweeps = 0
    events = []          # (start, end) CUDA events around each sweep
    timed = stats is not None and dev.type == "cuda"
    for q0 in range(0, n, qblock):
        q1 = min(q0 + qblock, n)
        qc = tier.rows_as_queries(q0, q1)
        # headroom over the 2g bound (g uses dequantized norms, which
        # track the true norms only up to the quantization error)
        margin = 4 * MATMUL_GUARD * (qc.norms + max_yn)
        while True:
            if timed:
                events.append(tuple(torch.cuda.Event(enable_timing=True)
                                    for _ in range(2)))
                events[-1][0].record()
            tau, sv_id, sv_lb, peak = _cascade_knn_sweep(
                tier, qc, q0, q1, k, dblock, cap.cap, margin, impl)
            if timed:
                events[-1][1].record()
            n_sweeps += 1
            need = int(peak)
            if need <= cap.cap:
                break
            cap.grow(need)
        final = (sv_id >= 0) & (sv_lb <= (tau + margin)[:, None])
        n_exact += final.sum()
        r, s = torch.nonzero(final, as_tuple=True)
        exact = torch.full(sv_id.shape, _INF, device=dev)
        exact[r, s] = ops.pairlist_sq_dists(
            vecs, vecs, (r + q0).to(torch.int32), sv_id[r, s], xn=vn, yn=vn,
            impl=impl)
        # ids ascend within a row, so a stable sort by distance orders
        # by (distance, id)
        dist, order = torch.sort(exact, dim=1, stable=True)
        out_d[q0:q1] = dist[:, :k]
        out_i[q0:q1] = torch.gather(torch.where(final, sv_id, NO_NODE), 1,
                                    order[:, :k])
    if stats is not None:
        n_pairs = n * n
        ne = int(n_exact)
        stats.knn_pairs += n_pairs
        stats.knn_exact += ne
        stats.tier_bytes += n_pairs * d
        stats.f32_bytes += ne * d * 4
        stats.f32_bytes_full += n_pairs * d * 4
        stats.knn_blocks += n_sweeps * -(-st.n_vectors // dblock)
        if events:
            events[-1][1].synchronize()
            stats.knn_sweep_s += sum(a.elapsed_time(b)
                                     for a, b in events) / 1e3
    return out_d, out_i


def _cascade_knn_sweep(tier, qc, q0: int, q1: int, k: int, dblock: int,
                       cap: int, margin: torch.Tensor, impl: str | None):
    """One query block's pass over the data blocks. Returns ``(τ (bq,),
    survivor ids (bq, cap) ascending per row, NO_NODE padded; their lower
    bounds (+inf padded); the largest survivor count any row reached)``
    — a count above ``cap`` means entries were dropped and the block must
    be redone at a larger cap."""
    n = tier.store.n_vectors
    dev = qc.q.device
    bq = q1 - q0
    bd = torch.full((bq, k), _INF, device=dev)
    bi = torch.full((bq, k), NO_NODE, dtype=torch.int32, device=dev)
    sv_id = torch.full((bq, cap), NO_NODE, dtype=torch.int32, device=dev)
    sv_lb = torch.full((bq, cap), _INF, device=dev)
    peak = torch.zeros((bq,), dtype=torch.int64, device=dev)
    for j0 in range(0, n, dblock):
        j1 = min(j0 + dblock, n)
        lb, ub = tier.pairwise_bounds(qc, impl=impl, y0=j0, y1=j1)
        _exclude_self(lb, q0, q1, j0, j1)
        _exclude_self(ub, q0, q1, j0, j1)
        bd, bi = ops.topk_merge(bd, bi, *_cut_block(ub, j0, k), impl=impl)
        thr = (bd[:, k - 1] + margin)[:, None]
        # buffered entries the tighter τ_run still admits, compacted left
        keep = sv_lb <= thr
        n_old = keep.sum(dim=1)
        pos = torch.where(keep, torch.cumsum(keep, dim=1) - 1, cap)
        nid = torch.full((bq, cap + 1), NO_NODE, dtype=torch.int32,
                         device=dev)
        nlb = torch.full((bq, cap + 1), _INF, device=dev)
        nid.scatter_(1, pos, sv_id)
        nlb.scatter_(1, pos, sv_lb)
        # this block's survivors after them, in column order
        r, c = torch.nonzero(lb <= thr, as_tuple=True)
        n_new = torch.bincount(r, minlength=bq)
        first = torch.cumsum(n_new, dim=0) - n_new
        rank = torch.arange(r.numel(), device=dev) - first[r]
        tgt = (n_old[r] + rank).clamp_max(cap)
        nid[r, tgt] = (c + j0).to(torch.int32)
        nlb[r, tgt] = lb[r, c]
        sv_id, sv_lb = nid[:, :cap].contiguous(), nlb[:, :cap].contiguous()
        peak = torch.maximum(peak, n_old + n_new)
    return bd[:, k - 1], sv_id, sv_lb, peak.max() if bq else 0


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


def _rng_prune_block_cascade(vecs: torch.Tensor, q: torch.Tensor,
                             norms: torch.Tensor, err: torch.Tensor,
                             sd: torch.Tensor, cand_ids: torch.Tensor,
                             cand_d: torch.Tensor, *, R: int
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Cascade-driven RNG pruning (``repro.core.graph.
    _rng_prune_block_cascade``): each ``dist(w,v) < dist(u,v)`` comparison
    is resolved from certified int8 bounds where they clear ``cand_d`` by
    the f32 kernel's rounding guard, and recomputed with the f32 path's own
    arithmetic (``_pair_sq_dists`` over a gathered tensor of the same
    shape, whose rows outside the band collapse to row 0) where they do
    not. Returns ``(pruned (b, R), n_f32_rows, n_amb_pairs)`` (0-d)."""
    from repro_torch.quant.cascade import MATMUL_GUARD

    safe = cand_ids.clamp_min(0).long()
    pair_hat = _pair_sq_dists(q[safe].float() * sd)          # dequantized
    nh, eh = norms[safe], err[safe]
    nsum = nh[:, :, None] + nh[:, None, :]
    slack = eh[:, :, None] + eh[:, None, :]
    guard_hat = MATMUL_GUARD * nsum
    lb = ops.quant_lower_bound(torch.clamp_min(pair_hat - guard_hat, 0.0),
                               slack)
    ub = ops.quant_upper_bound(pair_hat + guard_hat, slack)
    # f32-kernel rounding margin (2× headroom: nh are dequantized norms)
    g32 = (2 * MATMUL_GUARD) * nsum
    cd = cand_d[:, None, :]
    sure_lt = ub + g32 < cd
    sure_ge = lb - g32 >= cd
    valid = cand_ids != NO_NODE
    amb = (valid[:, :, None] & valid[:, None, :]) & ~(sure_lt | sure_ge)
    # f32 rows only for candidates in an ambiguous pair
    needed = torch.any(amb, dim=2) | torch.any(amb, dim=1)
    pair32 = _pair_sq_dists(vecs[torch.where(needed, safe, 0)])
    lt = torch.where(amb, pair32 < cd, sure_lt)
    return (_prune_from_lt(lt, valid, cand_ids, R), needed.sum(),
            amb.sum())


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
                quant=None, build_stats: BuildStats | None = None,
                knn_out: dict | None = None, device=None) -> GraphIndex:
    """Build a graph index over ``vecs`` (see ``repro.core.graph.build_index``).

    ``vecs`` is a tensor (kept on its device unless ``device`` is given) or
    an array (placed on ``device``; ``None`` means the CUDA card).
    ``quant`` is a quant mode name or a prebuilt ``FilterCascade`` over
    ``vecs``: with an int8 tier, the kNN sweep and the RNG prune run on
    certified bounds (the same edges; ``build_stats`` collects the
    traffic). ``knn_out``, if given, receives the kNN lists the prune
    started from (``"dists"``, ``"ids"``).
    """
    if style not in ("nsg", "nsw"):
        raise ValueError(f"unknown style {style!r}")
    vecs = _as_vecs(vecs, device)
    n, d = vecs.shape
    k = min(k, n - 1)
    cascade = None
    if quant is not None and quant != "off":
        if isinstance(quant, str):
            from repro_torch.quant.cascade import (TIERS_BY_MODE,
                                                   build_cascade)
            # the build consults only the confirming int8 tier; a mode
            # without one (pdx8, sketchpdx8) builds in f32, as the
            # reference's build does (its kNN and prune find no int8 tier)
            if "int8" in TIERS_BY_MODE[quant]:
                cascade = build_cascade(vecs, "sq8")
        else:
            cascade = quant
    cand_d, cand_i = exact_knn(vecs, k, impl=impl, cascade=cascade,
                               stats=build_stats)
    if knn_out is not None:
        knn_out.update(dists=cand_d, ids=cand_i)
    int8_tier = cascade.tier("int8") if cascade is not None else None
    if style == "nsw":
        half = max(degree // 2, 1)   # leave slots for reverse edges
        nbrs = torch.full((n, degree), NO_NODE, dtype=torch.int32,
                          device=vecs.device)
        nbrs[:, :half] = cand_i[:, :half]
    elif int8_tier is not None:
        from repro_torch.quant.store import dim_scales
        st = int8_tier.store
        sd = dim_scales(st.scales, d, st.group_size)
        nbrs = torch.empty((n, degree), dtype=torch.int32, device=vecs.device)
        n_rows = n_amb = 0
        for b0 in range(0, n, prune_block):
            b1 = min(b0 + prune_block, n)
            nbrs[b0:b1], rows, amb = _rng_prune_block_cascade(
                vecs, st.q, st.norms, st.err, sd, cand_i[b0:b1],
                cand_d[b0:b1], R=degree)
            n_rows = n_rows + rows
            n_amb = n_amb + amb
        if build_stats is not None:
            n_cand = int((cand_i >= 0).sum())
            build_stats.prune_pairs += n_cand * k
            build_stats.prune_exact += int(n_amb)
            build_stats.tier_bytes += n_cand * d
            build_stats.f32_bytes += int(n_rows) * d * 4
            build_stats.f32_bytes_full += n_cand * d * 4
    else:
        nbrs = torch.empty((n, degree), dtype=torch.int32, device=vecs.device)
        for b0 in range(0, n, prune_block):
            b1 = min(b0 + prune_block, n)
            nbrs[b0:b1] = _rng_prune_block(vecs, cand_i[b0:b1],
                                           cand_d[b0:b1], R=degree)
    del cand_d, cand_i, cascade
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
