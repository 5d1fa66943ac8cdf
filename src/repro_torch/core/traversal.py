"""Batched graph traversal (paper Alg. 2 & 4), in PyTorch.

Port of ``repro.core.traversal``: candidate probing with the per-lane
visited bitmap and in-batch dedup, the greedy best-first search of the
search-path methods (``greedy_search``), and ``range_expand`` (BFS, or
the hybrid BBFS for OOD queries), exact f32 or through a
``FilterCascade`` (``cascade_bounds``: every distance is then a certified
lower bound from the tiers' gather kernels — sketch Hamming, int8, PDX
int8 — and the hybrid beam carries certified upper bounds for its
eviction guard).

How the JAX primitives map here (each choice keeps the reference's exact
traversal order, so ``n_dist`` and ``n_iters`` match it):

  * ``lax.while_loop`` → a host-stepped loop of eager tensor ops with one
    ``bool(done.all())`` device→host sync per iteration;
  * ``lax.top_k`` (ties to the lower index) → a stable descending sort;
    ``jnp.argsort`` (stable) → ``torch.sort(..., stable=True)``;
    ``jnp.argmin`` → ``torch.min(..., dim)`` (the first minimum);
  * the uint32 visited bitmap → int32 words with the same bit layout
    (bit 31 is the sign); ``scatter_add_`` of distinct bits equals OR and
    never overflows;
  * ``.at[].set`` with an overflow sink column → ``scatter`` into the
    same sink, which is reset after every scatter;
  * ``.at[].max`` on bool flags with repeated targets →
    ``scatter_reduce(..., "amax")`` on int32.

All distances are squared L2; thresholds are squared (in f32) on entry.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.types import NO_NODE, GraphIndex, TraversalConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import sq_theta

_INF = float("inf")
_SORT_PAD = 2**30
# Offset that sorts beam entries protected by a certified upper bound
# ahead of every unprotected one (the reference's constant, in f32).
_PROTECT_OFF = 1e30


def bitmap_words(n_nodes: int) -> int:
    return -(-n_nodes // 32)


def bit_of(ids: torch.Tensor) -> torch.Tensor:
    """The int32 bitmap word bit of each node id (bit 31 is negative)."""
    return torch.bitwise_left_shift(torch.ones_like(ids), ids & 31)


# ---------------------------------------------------------------------------
# probing: distances + visited-dedup for a (B, K) candidate id matrix
# ---------------------------------------------------------------------------

def cascade_bounds(cascade, qc, cand: torch.Tensor, valid: torch.Tensor,
                   esc_th2: float, *, dist_impl: str | None):
    """Walk candidate ids through a ``FilterCascade``'s tier chain
    (``repro.core.traversal.cascade_bounds``).

    Tier 0 bounds every valid candidate; each later tier evaluates only
    the escalation set, the candidates whose running certified lower
    bound is still below ``esc_th2`` (θ²), and escalated candidates take
    the max of the lower bounds (the chain lb₀ ≤ lb₁ ≤ … ≤ d). Slots a
    tier does not evaluate pass NO_NODE, so its gather kernel reads no
    row for them (the reference collapses them to row 0 and discards the
    result; the bounds come out the same). Pruned candidates keep their
    certified floor but are ordered by the pruning tier's navigation
    estimate where it has one: ``max(lb, est)``.

    Returns ``(dist, ub, n_esc)``: the navigation/threshold distance, a
    certified upper bound (+inf where no tier with upper bounds evaluated
    the candidate) and the per-lane count of candidates escalated into
    tier 1 (``JoinStats.n_esc8``)."""
    B = cand.shape[0]
    lb = ub = est = None
    esc = valid
    n_esc = torch.zeros((B,), dtype=torch.int32, device=cand.device)
    for i, (tier, q) in enumerate(zip(cascade.tiers, qc)):
        if i > 0:
            esc = esc & (lb < esc_th2)
            if i == 1:
                n_esc = torch.sum(esc, dim=1, dtype=torch.int32)
        tlb, tub, test = tier.gather_bounds(
            q, torch.where(esc, cand, NO_NODE), impl=dist_impl)
        lb = tlb if i == 0 else torch.where(esc, torch.maximum(lb, tlb), lb)
        if tub is not None:
            tub = tub if i == 0 else torch.where(esc, tub, _INF)
            ub = tub if ub is None else torch.minimum(ub, tub)
        if test is not None and est is None:
            est = test
    dist = lb if est is None else torch.where(esc, lb,
                                              torch.maximum(lb, est))
    if ub is None:
        ub = torch.full_like(lb, _INF)
    return dist, ub, n_esc


def _probe(vecs: torch.Tensor, x: torch.Tensor, cand: torch.Tensor,
           valid: torch.Tensor, visited: torch.Tensor, *, n_data: int,
           traverse_nondata: bool, dist_impl: str | None, cascade=None,
           qc=None, esc_th2: float | None = None):
    """Distances to candidate ids with dedup + visited masking.

    ``visited`` (B, W) int32 is updated in place. Returns ``(dist (B,K) f32,
    +inf at invalid; ub (B,K) certified upper bounds (= dist on the exact
    path); valid; visited; n_new (B,) int32; n_esc (B,) int32 candidates
    escalated into tier 1)``. With a ``cascade`` (and ``qc`` =
    ``cascade.encode(x)``), ``dist`` is a certified lower bound (or, on a
    candidate a sketch tier pruned, its navigation estimate).
    """
    B, K = cand.shape
    valid = valid & (cand != NO_NODE)
    if not traverse_nondata:
        valid = valid & (cand < n_data)
    cand_c = torch.where(valid, cand, 0)
    w = (cand_c >> 5).long()
    bit = bit_of(cand_c)
    words = torch.gather(visited, 1, w)
    valid = valid & ((words & bit) == 0)
    # in-batch dedup (two expanded nodes sharing a neighbor): keep the
    # first occurrence in slot order
    sort_key = torch.where(valid, cand, _SORT_PAD)
    sorted_ids, order = torch.sort(sort_key, dim=1, stable=True)
    dup = torch.zeros_like(valid)
    dup[:, 1:] = sorted_ids[:, 1:] == sorted_ids[:, :-1]
    dup &= sorted_ids != _SORT_PAD
    keep = torch.ones_like(valid).scatter(1, order, ~dup)
    valid = valid & keep
    # invalid slots pass NO_NODE: the kernels read no row and return +inf,
    # which is the reference's masked value
    if cascade is not None:
        dist, ub, n_esc = cascade_bounds(cascade, qc, cand, valid,
                                         esc_th2, dist_impl=dist_impl)
        dist = torch.where(valid, dist, _INF)
        ub = torch.where(valid, ub, _INF)
    else:
        dist = ops.gather_sq_dists(vecs, x, torch.where(valid, cand, NO_NODE),
                                   impl=dist_impl)
        ub = dist
        n_esc = torch.zeros((B,), dtype=torch.int32, device=cand.device)
    # mark visited: deduped ⇒ each (word, bit) is added once ⇒ add == or
    visited.scatter_add_(1, w, torch.where(valid, bit, 0))
    n_new = torch.sum(valid, dim=1, dtype=torch.int32)
    return dist, ub, valid, visited, n_new, n_esc


def _expand(index_vecs: torch.Tensor, index_nbrs: torch.Tensor,
            x: torch.Tensor, sel_ids: torch.Tensor, sel_valid: torch.Tensor,
            visited: torch.Tensor, *, n_data: int, traverse_nondata: bool,
            dist_impl: str | None, cascade=None, qc=None,
            esc_th2: float | None = None):
    """Gather neighbor rows of selected nodes and probe them."""
    B, E = sel_ids.shape
    R = index_nbrs.shape[1]
    rows = index_nbrs[sel_ids.clamp_min(0).long()]           # (B, E, R)
    cand = rows.reshape(B, E * R)
    valid = sel_valid[:, :, None].expand(B, E, R).reshape(B, E * R)
    dist, ub, valid, visited, n_new, n_esc = _probe(
        index_vecs, x, cand, valid, visited, n_data=n_data,
        traverse_nondata=traverse_nondata, dist_impl=dist_impl,
        cascade=cascade, qc=qc, esc_th2=esc_th2)
    return cand, dist, ub, valid, visited, n_new, n_esc


def _take(a: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, 1, order)


def _hybrid_merge(bd, bi, bexp, bub, cd, ci, cexp, cub, *, protect_th2):
    """Merge the hybrid out-range beam with candidates, keep L entries and
    carry their certified upper bounds (stable: ties go to the beam, then
    to the lower slot). Entries whose upper bound beats ``protect_th2``
    sort ahead of every unprotected one, so eviction cannot drop a
    candidate certifiably within the protection radius (the OOD recall
    floor under quantized modes); ``protect_th2=None`` (exact f32, or the
    guard off) is a plain distance merge."""
    L = bd.shape[1]
    alld = torch.cat([bd, cd], dim=1)
    allu = torch.cat([bub, cub], dim=1)
    key = alld
    if protect_th2 is not None:
        key = torch.where(allu < protect_th2, allu - _PROTECT_OFF, alld)
    order = torch.sort(key, dim=1, stable=True)[1][:, :L]
    return (_take(alld, order), _take(torch.cat([bi, ci], dim=1), order),
            _take(torch.cat([bexp, cexp], dim=1), order), _take(allu, order))


def _mark(flags: torch.Tensor, pos: torch.Tensor, m: torch.Tensor
          ) -> torch.Tensor:
    """``flags.at[lane, pos].max(m)``: set flags[b, pos[b, j]] where m."""
    return flags.to(torch.int32).scatter_reduce(
        1, pos, m.to(torch.int32), "amax").bool()


def _beam_merge(bd, bi, bexp, cd, ci, cexp):
    """Merge the beam with candidates, keep the L smallest (stable: ties
    go to the beam, then to the lower slot); carry expanded flags."""
    L = bd.shape[1]
    alld = torch.cat([bd, cd], dim=1)
    order = torch.sort(alld, dim=1, stable=True)[1][:, :L]
    return (_take(alld, order), _take(torch.cat([bi, ci], dim=1), order),
            _take(torch.cat([bexp, cexp], dim=1), order))


# ---------------------------------------------------------------------------
# greedy (best-first) phase — paper Alg. 2 lines 5–28 + §4.1 early stopping
# ---------------------------------------------------------------------------

class GreedyState(NamedTuple):
    beam_dist: torch.Tensor     # (B, L) ascending squared dists
    beam_idx: torch.Tensor      # (B, L)
    beam_exp: torch.Tensor      # (B, L) expanded flags
    visited: torch.Tensor       # (B, W)
    best_dist: torch.Tensor     # (B,)
    best_idx: torch.Tensor      # (B,)
    since_improve: torch.Tensor  # (B,)
    done: torch.Tensor          # (B,)
    n_dist: torch.Tensor        # (B,)
    n_esc: torch.Tensor         # (B,) candidates escalated into tier 1
    n_iters: int                # loop iterations (host-stepped, exact)


def greedy_search(index: GraphIndex, x: torch.Tensor, seeds: torch.Tensor,
                  seeds_valid: torch.Tensor, theta: float, *,
                  cfg: TraversalConfig, n_data: int,
                  traverse_nondata: bool = True, cascade=None,
                  qc=None) -> GreedyState:
    """Batched best-first search until each lane finds an in-range point,
    runs out of unexpanded beam entries, or goes ``cfg.patience``
    iterations without a closer node (never, with patience < 0).

    ``x`` (B, d) is a wave of queries, ``seeds`` (B, S) int32 start node
    ids with ``seeds_valid`` (B, S). Under a ``cascade`` (``qc`` =
    ``cascade.encode(x)``) every distance is a certified lower bound
    walked through the tier chain (``_probe``). The visited bitmap it
    returns is what ``range_expand`` continues from.
    """
    vecs, nbrs = index.vecs, index.nbrs
    dev = x.device
    B = x.shape[0]
    L, E = cfg.beam_width, cfg.expand_per_iter
    th2 = sq_theta(theta)
    visited = torch.zeros((B, bitmap_words(vecs.shape[0])),
                          dtype=torch.int32, device=dev)

    # --- seed probing (Alg. 2 lines 5–11) ---
    d0, _, v0, visited, n_dist, n_esc = _probe(
        vecs, x, seeds, seeds_valid, visited, n_data=n_data,
        traverse_nondata=traverse_nondata, dist_impl=cfg.dist_impl,
        cascade=cascade, qc=qc, esc_th2=th2)
    seed_ids = torch.where(v0, seeds, NO_NODE)
    bd, bi, bexp = _beam_merge(
        torch.full((B, L), _INF, device=dev),
        torch.full((B, L), NO_NODE, dtype=torch.int32, device=dev),
        torch.zeros((B, L), dtype=torch.bool, device=dev),
        d0, seed_ids, torch.zeros_like(v0))
    best_dist, arg0 = torch.min(d0, dim=1)
    best_idx = torch.where(torch.isfinite(best_dist),
                           _take(seed_ids, arg0[:, None])[:, 0], NO_NODE)
    since = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = best_dist < th2
    n_iters = 0

    # host-stepped while loop: one device→host sync per iteration
    while n_iters < cfg.max_iters and not bool(done.all()):
        active = ~done
        # pick the E closest unexpanded beam entries; a stable descending
        # sort is lax.top_k's order (ties to the lower slot)
        key = torch.where((~bexp) & (bi != NO_NODE) & torch.isfinite(bd),
                          -bd, -_INF)
        selk, selpos = torch.sort(key, dim=1, descending=True, stable=True)
        selk, selpos = selk[:, :E], selpos[:, :E]
        sel_valid = (selk > -_INF) & active[:, None]
        sel_ids = _take(bi, selpos)
        new_exp = _mark(bexp, selpos, sel_valid)
        exhausted = ~torch.any(sel_valid, dim=1) & active

        # inactive lanes select nothing, so their visited words and counts
        # do not change: the update can go in place
        cand, cd, _, cv, visited, n_new, n_esc_new = _expand(
            vecs, nbrs, x, sel_ids, sel_valid, visited, n_data=n_data,
            traverse_nondata=traverse_nondata, dist_impl=cfg.dist_impl,
            cascade=cascade, qc=qc, esc_th2=th2)
        n_dist = n_dist + torch.where(active, n_new, 0)
        n_esc = n_esc + torch.where(active, n_esc_new, 0)

        cids = torch.where(cv, cand, NO_NODE)
        bd2, bi2, be2 = _beam_merge(bd, bi, new_exp, cd, cids,
                                    torch.zeros_like(cv))
        keep = active[:, None]
        bd = torch.where(keep, bd2, bd)
        bi = torch.where(keep, bi2, bi)
        bexp = torch.where(keep, be2, bexp)

        cbest, cargmin = torch.min(cd, dim=1)
        improved = cbest < best_dist
        best_dist = torch.where(active & improved, cbest, best_dist)
        best_idx = torch.where(active & improved,
                               _take(cids, cargmin[:, None])[:, 0], best_idx)
        since = torch.where(active, torch.where(improved, 0, since + 1),
                            since)

        done = done | (best_dist < th2) | exhausted
        if cfg.patience >= 0:
            done = done | (since >= cfg.patience)
        n_iters += 1

    return GreedyState(
        beam_dist=bd, beam_idx=bi, beam_exp=bexp, visited=visited,
        best_dist=best_dist, best_idx=best_idx, since_improve=since,
        done=done, n_dist=n_dist, n_esc=n_esc, n_iters=n_iters)


# ---------------------------------------------------------------------------
# range expansion — BFS (Alg. 2 lines 29–42) / hybrid BBFS (Alg. 4)
# ---------------------------------------------------------------------------

class ExpandResult(NamedTuple):
    pool_idx: torch.Tensor     # (B, C) in-range data node ids (NO_NODE padded)
    pool_dist: torch.Tensor    # (B, C)
    n_pool: torch.Tensor       # (B,)
    overflow: torch.Tensor     # (B,) in-range hits beyond pool capacity
    best_dist: torch.Tensor    # (B,) closest node seen overall
    best_idx: torch.Tensor     # (B,)
    n_dist: torch.Tensor       # (B,)
    n_esc: torch.Tensor        # (B,) candidates escalated into tier 1
    n_iters: int               # loop iterations (host-stepped, exact)
    visited: torch.Tensor      # (B, W)


class ExpandState(NamedTuple):
    """One iteration's state of ``range_expand`` (``expand_step`` maps
    it to the next). Pools carry the overflow sink column C."""
    pool_idx: torch.Tensor     # (B, C + 1)
    pool_dist: torch.Tensor    # (B, C + 1)
    pool_exp: torch.Tensor     # (B, C + 1) expanded flags
    n_pool: torch.Tensor       # (B,)
    overflow: torch.Tensor     # (B,)
    hb_dist: torch.Tensor      # (B, max(Lh, 1)) hybrid out-range beam
    hb_idx: torch.Tensor
    hb_exp: torch.Tensor
    hb_ub: torch.Tensor        # its certified upper bounds
    qmax_prev: torch.Tensor    # (B,) last max over the unexpanded beam
    stall: torch.Tensor        # (B,)
    done: torch.Tensor         # (B,)
    best_dist: torch.Tensor    # (B,)
    best_idx: torch.Tensor     # (B,)
    n_dist: torch.Tensor       # (B,)
    n_esc: torch.Tensor        # (B,)
    visited: torch.Tensor      # (B, W)


def _expand_consts(theta: float, cfg: TraversalConfig, hybrid: bool,
                   cascade) -> tuple[float, bool, float | None]:
    """(θ² in f32, whether the hybrid beam runs, its protection radius)."""
    th2 = sq_theta(theta)
    # eviction protection only matters when distances are bounds
    protect_th2 = (float(np.float32(cfg.hybrid_guard) * np.float32(th2))
                   if cascade is not None and cfg.hybrid_guard > 0 else None)
    return th2, hybrid and cfg.hybrid_beam > 0, protect_th2


def expand_init(x: torch.Tensor, theta: float, *, cfg: TraversalConfig,
                n_data: int, hybrid: bool, init_idx: torch.Tensor,
                init_dist: torch.Tensor, init_valid: torch.Tensor,
                visited: torch.Tensor, best_dist: torch.Tensor,
                best_idx: torch.Tensor, n_dist: torch.Tensor, cascade=None,
                init_ub: torch.Tensor | None = None,
                n_esc: torch.Tensor | None = None) -> ExpandState:
    """``range_expand``'s state before its first iteration: the in-range
    initial candidates in the pool, the rest in the hybrid beam."""
    dev = x.device
    B, K0 = init_idx.shape
    C, Lh = cfg.pool_cap, cfg.hybrid_beam
    th2, use_hb, protect_th2 = _expand_consts(theta, cfg, hybrid, cascade)
    if init_ub is None:
        init_ub = torch.full_like(init_dist, _INF)
    if n_esc is None:
        n_esc = torch.zeros((B,), dtype=torch.int32, device=dev)

    is_data = (init_idx >= 0) & (init_idx < n_data)
    inr = init_valid & is_data & (init_dist < th2)

    # --- scatter in-range entries into the pool (slot C = overflow sink) ---
    pool_idx = torch.full((B, C + 1), NO_NODE, dtype=torch.int32, device=dev)
    pool_dist = torch.full((B, C + 1), _INF, device=dev)
    pos = torch.cumsum(inr, dim=1) - 1
    pos = torch.where(inr, pos.clamp_max(C), C)
    pool_idx.scatter_(1, pos, torch.where(inr, init_idx, NO_NODE))
    pool_dist.scatter_(1, pos, torch.where(inr, init_dist, _INF))
    pool_idx[:, C] = NO_NODE
    pool_dist[:, C] = _INF
    n_inr = torch.sum(inr, dim=1, dtype=torch.int32)
    n_pool = n_inr.clamp_max(C)
    overflow = (n_inr - C).clamp_min(0)

    # --- hybrid beam init: out-range / non-data initial candidates ---
    L1 = max(Lh, 1)
    hb_dist = torch.full((B, L1), _INF, device=dev)
    hb_idx = torch.full((B, L1), NO_NODE, dtype=torch.int32, device=dev)
    hb_exp = torch.zeros((B, L1), dtype=torch.bool, device=dev)
    hb_ub = torch.full((B, L1), _INF, device=dev)
    if use_hb:
        outr = init_valid & ~inr
        hb_dist, hb_idx, hb_exp, hb_ub = _hybrid_merge(
            hb_dist, hb_idx, hb_exp, hb_ub,
            torch.where(outr, init_dist, _INF),
            torch.where(outr, init_idx, NO_NODE), torch.zeros_like(outr),
            torch.where(outr, init_ub, _INF), protect_th2=protect_th2)

    pool_exp = torch.zeros((B, C + 1), dtype=torch.bool, device=dev)
    pool_exp[:, C] = True
    return ExpandState(
        pool_idx=pool_idx, pool_dist=pool_dist, pool_exp=pool_exp,
        n_pool=n_pool, overflow=overflow, hb_dist=hb_dist, hb_idx=hb_idx,
        hb_exp=hb_exp, hb_ub=hb_ub,
        qmax_prev=torch.full((B,), _INF, device=dev),
        stall=torch.zeros((B,), dtype=torch.int32, device=dev),
        done=torch.zeros((B,), dtype=torch.bool, device=dev),
        best_dist=best_dist, best_idx=best_idx, n_dist=n_dist, n_esc=n_esc,
        visited=visited)


def expand_step(st: ExpandState, index: GraphIndex, x: torch.Tensor,
                theta: float, *, cfg: TraversalConfig, n_data: int,
                hybrid: bool, traverse_nondata: bool, cascade=None,
                qc=None) -> ExpandState:
    """One iteration of ``range_expand``'s loop, with no device→host sync:
    select up to E unexpanded entries (pool first), probe their neighbor
    rows, append the in-range hits to the pool, let the hybrid beam absorb
    the rest, track the best, and update ``done`` and ``stall``. Lanes
    already done change nothing but ``st.visited``, updated in place."""
    vecs, nbrs = index.vecs, index.nbrs
    C, E = cfg.pool_cap, cfg.expand_per_iter
    th2, use_hb, protect_th2 = _expand_consts(theta, cfg, hybrid, cascade)
    (pool_idx, pool_dist, pool_exp, n_pool, overflow, hb_dist, hb_idx,
     hb_exp, hb_ub, qmax_prev, stall, done, best_dist, best_idx, n_dist,
     n_esc, visited) = st
    active = ~done
    # --- select up to E unexpanded entries: pool (in-range) first ---
    # 2e30 − d rounds to 2e30 in f32, so every unexpanded pool entry
    # ties and selection goes lowest slot first (BFS in pool order)
    pkey = torch.where((~pool_exp) & (pool_idx != NO_NODE),
                       2e30 - pool_dist, -_INF)
    if use_hb:
        hkey = torch.where((~hb_exp) & (hb_idx != NO_NODE)
                           & torch.isfinite(hb_dist), -hb_dist, -_INF)
        key = torch.cat([pkey, hkey], dim=1)
    else:
        key = pkey
    selk, selpos = torch.sort(key, dim=1, descending=True, stable=True)
    selk, selpos = selk[:, :E], selpos[:, :E]
    sel_valid = (selk > -_INF) & active[:, None]
    from_pool = selpos < (C + 1)
    pool_pos = torch.where(from_pool, selpos, 0)
    hb_pos = torch.where(from_pool, 0, selpos - (C + 1))
    sel_ids = torch.where(from_pool, _take(pool_idx, pool_pos),
                          _take(hb_idx, hb_pos))
    pool_exp = _mark(pool_exp, pool_pos, sel_valid & from_pool)
    if use_hb:
        hb_exp = _mark(hb_exp, hb_pos, sel_valid & ~from_pool)
    any_inrange_unexp = torch.any((~pool_exp) & (pool_idx != NO_NODE),
                                  dim=1)
    any_sel = torch.any(sel_valid, dim=1)
    exhausted = ~any_sel & active

    # inactive lanes select nothing, so their visited words and counts
    # do not change: the update can go in place
    cand, cd, cub, cv, visited, n_new, n_esc_new = _expand(
        vecs, nbrs, x, sel_ids, sel_valid, visited, n_data=n_data,
        traverse_nondata=traverse_nondata, dist_impl=cfg.dist_impl,
        cascade=cascade, qc=qc, esc_th2=th2)
    n_dist = n_dist + torch.where(active, n_new, 0)
    n_esc = n_esc + torch.where(active, n_esc_new, 0)

    cis_data = (cand >= 0) & (cand < n_data)
    cinr = cv & cis_data & (cd < th2) & active[:, None]

    # --- append in-range hits to the pool ---
    cpos = n_pool[:, None] + torch.cumsum(cinr, dim=1) - 1
    cpos = torch.where(cinr, cpos.clamp_max(C), C)
    pool_idx2 = pool_idx.scatter(1, cpos, torch.where(cinr, cand, NO_NODE))
    pool_dist2 = pool_dist.scatter(1, cpos, torch.where(cinr, cd, _INF))
    pool_idx2[:, C] = NO_NODE
    pool_dist2[:, C] = _INF
    pool_exp[:, C] = True
    n_hits = torch.sum(cinr, dim=1, dtype=torch.int32)
    n_pool2 = (n_pool + n_hits).clamp_max(C)
    overflow2 = (overflow + (n_pool + n_hits - C).clamp_min(0)
                 - (n_pool - C).clamp_min(0))

    # --- hybrid beam absorbs the rest (bounded, Alg. 4 lines 12–16) ---
    if use_hb:
        cout = cv & ~cinr & active[:, None]
        hb_dist, hb_idx, hb_exp, hb_ub = _hybrid_merge(
            hb_dist, hb_idx, hb_exp, hb_ub,
            torch.where(cout, cd, _INF),
            torch.where(cout, cand, NO_NODE), torch.zeros_like(cout),
            torch.where(cout, cub, _INF), protect_th2=protect_th2)

    # --- best-seen tracking (Alg. 2 lines 38–39) ---
    cbest, cargmin = torch.min(cd, dim=1)
    improved = cbest < best_dist
    cbesti = _take(torch.where(cv, cand, NO_NODE), cargmin[:, None])[:, 0]
    best_dist = torch.where(active & improved, cbest, best_dist)
    best_idx = torch.where(active & improved, cbesti, best_idx)

    # --- termination ---
    if use_hb:
        # max over *unexpanded* queue entries (Alg. 4 lines 14–16)
        qmax = torch.max(torch.where((hb_idx != NO_NODE) & ~hb_exp,
                                     hb_dist, -_INF), dim=1)[0]
        no_inr = ~(any_inrange_unexp | (n_hits > 0))
        decreased = qmax < qmax_prev
        stall = torch.where(active,
                            torch.where(no_inr & ~decreased, stall + 1, 0),
                            stall)
        done = done | exhausted | ((stall >= cfg.hybrid_patience) & no_inr)
        qmax_prev = torch.where(active, qmax, qmax_prev)
    else:
        done = done | exhausted | (
            ~(any_inrange_unexp | (n_hits > 0)) & active)

    keep = active & any_sel
    return ExpandState(
        pool_idx=torch.where(keep[:, None], pool_idx2, pool_idx),
        pool_dist=torch.where(keep[:, None], pool_dist2, pool_dist),
        pool_exp=pool_exp, n_pool=torch.where(keep, n_pool2, n_pool),
        overflow=torch.where(keep, overflow2, overflow), hb_dist=hb_dist,
        hb_idx=hb_idx, hb_exp=hb_exp, hb_ub=hb_ub, qmax_prev=qmax_prev,
        stall=stall, done=done, best_dist=best_dist, best_idx=best_idx,
        n_dist=n_dist, n_esc=n_esc, visited=visited)


def range_expand(index: GraphIndex, x: torch.Tensor, theta: float, *,
                 cfg: TraversalConfig, n_data: int, hybrid: bool,
                 traverse_nondata: bool, init_idx: torch.Tensor,
                 init_dist: torch.Tensor, init_valid: torch.Tensor,
                 visited: torch.Tensor, best_dist: torch.Tensor,
                 best_idx: torch.Tensor, n_dist: torch.Tensor,
                 cascade=None, qc=None, init_ub: torch.Tensor | None = None,
                 n_esc: torch.Tensor | None = None,
                 n_steps: int | None = None) -> ExpandResult:
    """Enumerate all reachable in-range data points from initial candidates.

    ``init_*`` (B, K0) are already-visited candidates with known distances
    (for the merged index, the probed neighbor row). In-range data entries
    seed the result pool; the rest seed the hybrid out-range beam (BBFS
    only — plain BFS drops them). ``visited`` is updated in place.

    Under a ``cascade`` every distance is a certified lower bound, so the
    pool is a superset of the exact one and the caller re-ranks it; the
    hybrid beam carries (lb, ub) pairs (``init_ub`` for the initial
    candidates) and protects entries with ub < ``hybrid_guard``·θ² from
    eviction. ``n_esc`` (B,) carries the probe's tier-1 escalations.

    The host steps ``expand_step`` from ``expand_init``'s state until
    every lane is done or ``cfg.max_iters`` iterations have run; with
    ``n_steps`` it runs exactly that many, with no sync (the dry run's
    separated iteration, which fake tensors can run).
    """
    st = expand_init(x, theta, cfg=cfg, n_data=n_data, hybrid=hybrid,
                     init_idx=init_idx, init_dist=init_dist,
                     init_valid=init_valid, visited=visited,
                     best_dist=best_dist, best_idx=best_idx, n_dist=n_dist,
                     cascade=cascade, init_ub=init_ub, n_esc=n_esc)
    n_iters = 0
    # host-stepped while loop: one device→host sync per iteration
    while (n_iters < n_steps if n_steps is not None else
           n_iters < cfg.max_iters and not bool(st.done.all())):
        st = expand_step(st, index, x, theta, cfg=cfg, n_data=n_data,
                         hybrid=hybrid, traverse_nondata=traverse_nondata,
                         cascade=cascade, qc=qc)
        n_iters += 1
    return expand_result(st, cfg.pool_cap, n_iters)


def expand_result(st: ExpandState, C: int, n_iters: int) -> ExpandResult:
    """The pool (sink column dropped) and counters of a final state."""
    return ExpandResult(
        pool_idx=st.pool_idx[:, :C], pool_dist=st.pool_dist[:, :C],
        n_pool=st.n_pool, overflow=st.overflow, best_dist=st.best_dist,
        best_idx=st.best_idx, n_dist=st.n_dist, n_esc=st.n_esc,
        n_iters=n_iters, visited=st.visited)
