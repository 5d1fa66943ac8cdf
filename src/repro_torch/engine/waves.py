"""Wave runners of the join (port of ``repro.engine.waves``).

Queries are processed in waves of ``JoinConfig.wave_size`` lanes; a short
final wave is padded with invalid lanes that are masked throughout. Each
wave has a device phase (``launch_mi_wave``: probe the query's own
merged-index row, then BFS / hybrid BBFS, then the epilogue
``_finalize_wave``) and a host phase (``assemble_wave``: one device→host
transfer of the pool block, then pair assembly). Under a quantized mode
the traversal runs on certified lower bounds walked through the cascade's
tiers, and the epilogue splits the pool into certified-sure entries and an
ambiguous band that is re-ranked exactly through a ``RerankCap``-wide
compaction (the f32 gather kernel, or, with a PDX tier, the PDX gather
kernel with early exit at θ² over the store's f32 PDX mirror); a wave
whose band overflows the cap grows it and re-runs the epilogue
(``_resolve_band``), so the emitted pairs never depend on the cap. With
overlap on, wave k+1 is launched before wave k is assembled, the
reference's launch → launch → assemble order; pair sets are identical
either way.

The traversal loop is host-stepped (one sync per iteration), so the
device is mostly idle while the host assembles: the overlap keeps the
reference's order and stats rather than hiding host time. A second CUDA
stream with pinned non-blocking copies is later work.

The search-path waves (``index``/``es``/``es_hws``/``es_sws``,
``run_search_join``) run a greedy search from seeds over the data index
G_Y, then the BFS range expansion from its beam. ``es_hws`` and ``es_sws``
run in MST wavefronts over the query index G_X and seed each query from
its parent's cache entry (Alg. 1 and 3: the whole kept pool for HWS, the
closest node for SWS); with overlap on, the next wave seeds from a small
blocking fetch of the previous wave's seed feedback (``fetch_feedback``)
while its pool is still on the device.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import ordering, traversal
from repro_torch.core.ood import predict_ood
from repro_torch.core.types import (NO_NODE, GraphIndex, JoinConfig,
                                    JoinStats, TraversalConfig,
                                    early_exit_enabled, env_flag)
from repro_torch.kernels import ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

_INF = float("inf")


def overlap_enabled(cfg: JoinConfig) -> bool:
    """``cfg.overlap``, unless the ``REPRO_OVERLAP`` env var overrides it."""
    return env_flag("REPRO_OVERLAP", cfg.overlap)


next_pow2 = ops.next_pow2
StickyCap = ops.StickyCap


class RerankCap(StickyCap):
    """``StickyCap`` for the ambiguous-band re-rank, sized from the
    traversal config (``init_cap`` overrides the cold start)."""

    def __init__(self, tcfg: TraversalConfig, init_cap: int | None = None):
        init = (init_cap if init_cap is not None and init_cap > 0
                else tcfg.rerank_cap if tcfg.rerank_cap > 0
                else tcfg.pool_cap)
        super().__init__(init, tcfg.pool_cap)


# ---------------------------------------------------------------------------
# padding / assembly helpers
# ---------------------------------------------------------------------------

def pad_wave(ids: np.ndarray, wave_size: int) -> tuple[np.ndarray, np.ndarray]:
    n = ids.shape[0]
    if n == wave_size:
        return ids, np.ones(n, bool)
    pad = np.zeros(wave_size - n, ids.dtype)
    return np.concatenate([ids, pad]), np.concatenate(
        [np.ones(n, bool), np.zeros(wave_size - n, bool)])


def pool_mask(lane_valid: np.ndarray, n_pool: np.ndarray,
              C: int) -> np.ndarray:
    """(B, C) bool — which pool slots hold results (first-n layout)."""
    n_pool = np.where(lane_valid, n_pool, 0)
    return np.arange(C)[None, :] < n_pool[:, None]


def collect_pairs(qids: np.ndarray, keep: np.ndarray,
                  pool_idx: np.ndarray) -> np.ndarray:
    """Pairs from every kept pool slot; ``keep`` is a (B, C) bool mask."""
    lanes, slots = np.nonzero(keep)
    return np.stack([qids[lanes], pool_idx[lanes, slots]], axis=1).astype(
        np.int64)


# ---------------------------------------------------------------------------
# device-side wave epilogue
# ---------------------------------------------------------------------------

def _finalize_wave(cascade, qc, vecs: torch.Tensor, xw: torch.Tensor,
                   pool_idx: torch.Tensor, pool_dist: torch.Tensor,
                   n_pool: torch.Tensor, lane_valid: torch.Tensor,
                   best_idx: torch.Tensor, th2: float, *, cap: int,
                   dist_impl: str | None, seed_mode: str = "none",
                   seeds_max: int = 0, early_exit: bool = False):
    """Device epilogue of one wave (the reference's ``_finalize_wave``).
    Without a cascade every filled pool slot of a
    valid lane is emitted. With one, the pooled lower bounds split into
    certified-sure entries and an ambiguous band; only the band, compacted
    to ``cap`` slots per lane, is re-ranked exactly: by the f32 gather
    kernel, or, when the cascade has a PDX tier, by the PDX gather kernel
    over its f32 mirror, which with ``early_exit`` retires lanes whose
    partial sum plus certified tail bound exceeds θ² (+inf; their full
    sum is certified ≥ θ², so ``keep`` and ``dist`` are the same on and
    off).

    Returns ``(keep (B, C), dist (B, C) — exact where re-ranked, +inf off
    keep, n_amb (B,) band occupancy, seed_ids / seed_valid (B, S) — the
    seed feedback, n_dims_scanned, n_dims_total — 0-d PDX re-rank scan
    counters, 0 without a PDX tier)``; band entries ranked ≥ ``cap`` were
    not re-ranked, so the caller retries when ``n_amb > cap``. The seed
    feedback is, for ``seed_mode="es_hws"``, the first ``seeds_max`` kept
    pool slots in ascending (dist, id) order — the order
    ``update_sws_cache`` stores, so both agree bit for bit; for
    ``"es_sws"`` the lane's best node; for ``"none"`` empty."""
    B, C = pool_idx.shape
    dev = pool_idx.device
    keep = ((torch.arange(C, device=dev)[None, :] < n_pool[:, None])
            & lane_valid[:, None])
    dist = pool_dist
    n_amb = torch.zeros((B,), dtype=torch.int32, device=dev)
    n_scanned = torch.zeros((), dtype=torch.int64, device=dev)
    n_total = torch.zeros((), dtype=torch.int64, device=dev)
    if cascade is not None:
        sure, amb = cascade.pool_band(qc, pool_dist, pool_idx, th2)
        sure = keep & sure
        amb = keep & amb
        pdx = cascade.tier("pdx")
        if pdx is not None:
            st = pdx.store
            qcp = qc[cascade.names.index("pdx")]
            exact, within, n_amb, n_scanned, n_total = \
                ops.pdx_compact_gather_sq_dists(
                    st.vp, st.ftail, st.ftail[:, 0].contiguous(), qcp.vp,
                    qcp.ftail, qcp.ftail[:, 0].contiguous(), pool_idx, amb,
                    min(cap, C), th2, dim=st.dim, early_exit=early_exit,
                    impl=dist_impl)
            keep = sure | (within & (exact < th2))
            # exact < th2, not isfinite: a retired slot reads +inf here and
            # a finite value ≥ θ² with exit off; both keep pool_dist
            dist = torch.where(within & (exact < th2), exact, pool_dist)
        else:
            exact, within, n_amb = ops.compact_gather_sq_dists(
                vecs, xw, pool_idx, amb, min(cap, C), impl=dist_impl)
            keep = sure | (within & (exact < th2))
            dist = torch.where(within & torch.isfinite(exact), exact,
                               pool_dist)
    dist = torch.where(keep, dist, _INF)
    if seed_mode == "es_hws":
        # lexicographic (dist, id): a stable sort by id, then by dist
        by_id = torch.sort(pool_idx, dim=1, stable=True)[1]
        sd, o = torch.sort(torch.gather(dist, 1, by_id), dim=1, stable=True)
        S = min(seeds_max, C)
        seed_ids = torch.gather(pool_idx, 1, torch.gather(by_id, 1, o))[:, :S]
        seed_valid = torch.isfinite(sd[:, :S])
    elif seed_mode == "es_sws":
        seed_ids = best_idx[:, None].to(torch.int32)
        seed_valid = (best_idx != NO_NODE)[:, None] & lane_valid[:, None]
    else:
        seed_ids = torch.zeros((B, 0), dtype=torch.int32, device=dev)
        seed_valid = torch.zeros((B, 0), dtype=torch.bool, device=dev)
    return keep, dist, n_amb, seed_ids, seed_valid, n_scanned, n_total


@dataclasses.dataclass
class WaveHandles:
    """One in-flight wave: device handles plus host-side bookkeeping."""
    qids: np.ndarray               # (B,) global query ids
    lane_valid: np.ndarray         # (B,) bool
    xw: torch.Tensor               # (B, d) wave queries (device)
    vecs: torch.Tensor             # index vector table (device)
    cascade: object                # FilterCascade | None
    qc: tuple | None
    th2: float
    # raw traversal outputs (kept for the retry path)
    pool_idx: torch.Tensor
    raw_pool_dist: torch.Tensor
    n_pool: torch.Tensor
    best_idx: torch.Tensor
    n_dist: torch.Tensor
    n_esc: torch.Tensor
    overflow: torch.Tensor
    n_iters: tuple                 # host ints, summed at assembly
    # epilogue outputs (replaced wholesale on a capacity retry)
    keep: torch.Tensor
    dist: torch.Tensor
    n_amb: torch.Tensor
    seed_ids: torch.Tensor         # (B, S) seed feedback (S = 0: none)
    seed_valid: torch.Tensor
    n_dims_scanned: torch.Tensor   # () PDX re-rank scan counters
    n_dims_total: torch.Tensor
    capctl: RerankCap
    cap: int                       # band capacity the epilogue ran at
    dist_impl: str | None
    seed_mode: str = "none"
    seeds_max: int = 0
    early_exit: bool = False
    # device-phase trace span ("traversal" lane), opened at dispatch and
    # closed at the first host contact with the results (_resolve_band)
    span: object = None
    n_amb_host: np.ndarray | None = None
    # streamed queries evicted from the engine's carry window before this
    # wave's cache update landed; their entries are dropped once written
    tombstones: list = dataclasses.field(default_factory=list)


def _count_band(h: WaveHandles, stats: JoinStats) -> None:
    if h.cascade is not None:
        stats.n_rerank_gather += int(h.xw.shape[0]) * h.cap
        stats.bytes_band += (int(h.xw.shape[0]) * h.cap
                             * int(h.xw.shape[1]) * 4)


def _refinalize(h: WaveHandles, stats: JoinStats) -> None:
    """Re-run the device epilogue at the (grown) capacity."""
    h.cap = h.capctl.cap
    with obs_trace.tracer().span("wave/refinalize", lane="assembly",
                                 cap=h.cap):
        (h.keep, h.dist, h.n_amb, h.seed_ids, h.seed_valid, h.n_dims_scanned,
         h.n_dims_total) = _finalize_wave(
            h.cascade, h.qc, h.vecs, h.xw, h.pool_idx, h.raw_pool_dist,
            h.n_pool, torch.as_tensor(h.lane_valid, device=h.xw.device),
            h.best_idx, h.th2, cap=h.cap, dist_impl=h.dist_impl,
            seed_mode=h.seed_mode, seeds_max=h.seeds_max,
            early_exit=h.early_exit)
    _count_band(h, stats)


def _resolve_band(h: WaveHandles, stats: JoinStats) -> None:
    """First host contact with a wave: fetch the per-lane band occupancy;
    if a lane's band overflowed the capacity the wave's epilogue ran at,
    grow the cap and re-run the epilogue, so the emitted set never depends
    on the cap. Closes the device span.

    The check is against the wave's own dispatch-time capacity, not the
    sticky cap: with overlap on, an earlier wave's retry can grow the
    sticky cap after this wave was dispatched. (The reference compares
    with the sticky cap there and drops the band entries ranked between
    the two capacities.)"""
    if h.n_amb_host is not None:
        return
    tr = obs_trace.tracer()
    t0 = time.perf_counter()
    with tr.span("wave/band", lane="assembly") as sp:
        n_amb = h.n_amb.cpu().numpy()
        max_amb = int(n_amb.max()) if n_amb.size else 0
        if h.cascade is not None and max_amb > h.cap:
            if tr:
                tr.instant("wave/overflow_retry", lane="traversal",
                           needed=max_amb, cap=h.cap)
            stats.overflow_retries += 1
            h.capctl.grow(max_amb)
            _refinalize(h, stats)
            n_amb = h.n_amb.cpu().numpy()
        if sp:
            sp.set(band_occ=max_amb, cap=h.cap)
    if h.span:
        h.span.end(band_occ=max_amb, cap=h.cap)
    h.n_amb_host = n_amb
    stats.wait_seconds += time.perf_counter() - t0
    stats.bytes_feedback += n_amb.nbytes
    obs_metrics.metrics().histogram(
        "wave.band_occ", help="per-wave max ambiguous-band occupancy"
    ).observe(max_amb)


def fetch_feedback(h: WaveHandles, stats: JoinStats) -> dict[int, np.ndarray]:
    """The small blocking transfer between pipelined search waves: the band
    occupancy (for the cap retry) and the per-lane seed entries. Returns
    the seed overlay ``{qid: ids}``; for a caching method these are the
    first ``seeds_max`` ids ``update_sws_cache`` later stores for the same
    queries, so the next wave can seed from them before the pool reaches
    the host."""
    _resolve_band(h, stats)
    if h.seed_mode == "none":
        return {}
    t0 = time.perf_counter()
    with obs_trace.tracer().span("wave/feedback", lane="assembly"):
        seed_ids = h.seed_ids.cpu().numpy()
        seed_valid = h.seed_valid.cpu().numpy()
    stats.wait_seconds += time.perf_counter() - t0
    stats.bytes_feedback += seed_ids.nbytes + seed_valid.nbytes
    return {int(q): np.asarray(seed_ids[i][seed_valid[i]], np.int32)
            for i, q in enumerate(h.qids) if h.lane_valid[i]}


@dataclasses.dataclass
class WaveOutput:
    """What a caller needs to assemble pairs after one wave."""
    pairs: np.ndarray          # (P, 2) int64, already offset to global qids
    pool_idx: np.ndarray       # (B, C) int32
    pool_dist: np.ndarray      # (B, C) f32
    pool_keep: np.ndarray      # (B, C) bool — emitted slots
    n_pool: np.ndarray         # (B,) int32
    best_idx: np.ndarray       # (B,) int32 — closest data node per lane
    lane_valid: np.ndarray     # (B,) bool


def assemble_wave(h: WaveHandles, stats: JoinStats, *,
                  qid_offset: int = 0) -> WaveOutput:
    """The host phase of one wave: one device→host transfer of the (idx,
    dist, keep, stats) block, then pair assembly."""
    _resolve_band(h, stats)
    t0 = time.perf_counter()
    with obs_trace.tracer().span("wave/assemble", lane="assembly") as sp:
        (pool_idx, pool_dist, keep, n_pool, best_idx, n_dist, n_esc,
         overflow, nds, ndt) = (t.cpu().numpy() for t in (
             h.pool_idx, h.dist, h.keep, h.n_pool, h.best_idx, h.n_dist,
             h.n_esc, h.overflow, h.n_dims_scanned, h.n_dims_total))
        lv = h.lane_valid
        pairs = collect_pairs(h.qids + qid_offset, keep, pool_idx)
        stats.n_dist += int(n_dist[lv].sum())
        stats.n_esc8 += int(n_esc[lv].sum())
        stats.n_overflow += int(overflow[lv].sum())
        stats.n_rerank += int(h.n_amb_host[lv].sum())
        stats.n_dims_scanned += int(nds)
        stats.n_dims_total += int(ndt)
        stats.n_iters += sum(h.n_iters)
        stats.bytes_assembly += (
            pool_idx.nbytes + pool_dist.nbytes + keep.nbytes + n_pool.nbytes
            + best_idx.nbytes + n_dist.nbytes + n_esc.nbytes
            + overflow.nbytes)
        if sp:
            sp.set(pairs=int(pairs.shape[0]),
                   lanes=int(np.count_nonzero(lv)))
    stats.other_seconds += time.perf_counter() - t0
    obs_metrics.metrics().histogram(
        "wave.pairs", help="result pairs emitted per wave"
    ).observe(pairs.shape[0])
    return WaveOutput(pairs=pairs, pool_idx=pool_idx, pool_dist=pool_dist,
                      pool_keep=keep, n_pool=n_pool, best_idx=best_idx,
                      lane_valid=lv)


# ---------------------------------------------------------------------------
# MI seed probing (greedy phase offloaded to the index — paper §4.4)
# ---------------------------------------------------------------------------

def _mi_probe(merged: GraphIndex, x: torch.Tensor, qids: torch.Tensor,
              lane_valid: torch.Tensor, *, traverse_nondata: bool,
              dist_impl: str | None, cascade=None, qc=None,
              esc_th2: float | None = None,
              visited: torch.Tensor | None = None):
    """Probe each query's own neighborhood row in the merged index
    (``visited``: a bitmap to start from, updated in place; empty if
    omitted)."""
    B = x.shape[0]
    if visited is None:
        visited = torch.zeros((B, traversal.bitmap_words(merged.n_nodes)),
                              dtype=torch.int32, device=x.device)
    # mark the query's own node visited so traversal never loops back
    visited.scatter_add_(1, (qids >> 5).long()[:, None],
                         traversal.bit_of(qids)[:, None])
    rows = merged.nbrs[qids.long()]                          # (B, R)
    valid = lane_valid[:, None].expand(rows.shape)
    dist, ub, valid, visited, n_new, n_esc = traversal._probe(
        merged.vecs, x, rows, valid, visited, n_data=merged.n_data,
        traverse_nondata=traverse_nondata, dist_impl=dist_impl,
        cascade=cascade, qc=qc, esc_th2=esc_th2)
    best, arg = torch.min(dist, dim=1)
    besti = torch.gather(torch.where(valid, rows, NO_NODE), 1,
                         arg[:, None])[:, 0]
    return rows, dist, ub, valid, visited, n_new, n_esc, best, besti


# ---------------------------------------------------------------------------
# merged-index waves (es_mi / es_mi_adapt)
# ---------------------------------------------------------------------------

def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def launch_mi_wave(merged: GraphIndex, xw: torch.Tensor, qids: np.ndarray,
                   lane_valid: np.ndarray, cfg: JoinConfig,
                   stats: JoinStats, *, hybrid: bool, cascade=None,
                   qc=None, capctl: RerankCap | None = None,
                   sync: bool = True) -> WaveHandles:
    """The device phase of one merged-index wave (probe + BFS/BBFS
    expansion + epilogue with the band-compacted re-rank). With ``sync``
    the probe and expansion phases are timed separately (the sequential
    path). ``cascade`` compresses the merged index (data and query
    nodes); ``qc`` is ``cascade.encode(xw)`` (encoded here if omitted)."""
    tcfg = cfg.traversal
    dev = xw.device
    n_data = merged.n_data
    node_ids = torch.as_tensor(qids, device=dev).to(torch.int32) + n_data
    lv = torch.as_tensor(lane_valid, device=dev)
    if cascade is not None and qc is None:
        qc = cascade.encode(xw)
    th2 = traversal.sq_theta(cfg.theta)
    if capctl is None:
        capctl = RerankCap(tcfg)
    tr = obs_trace.tracer()
    lsp = tr.span("wave/launch", lane="assembly")

    dspan = tr.begin("wave/device", lane="traversal", cap=capctl.cap)
    t0 = time.perf_counter()
    rows, dist, ub, valid, visited, n_new, n_esc0, best, besti = _mi_probe(
        merged, xw, node_ids, lv, traverse_nondata=hybrid,
        dist_impl=tcfg.dist_impl, cascade=cascade, qc=qc, esc_th2=th2)
    if sync:
        _sync(dist)
        stats.greedy_seconds += time.perf_counter() - t0
        t0 = time.perf_counter()

    r = traversal.range_expand(
        merged, xw, cfg.theta, cfg=tcfg, n_data=n_data,
        hybrid=hybrid, traverse_nondata=hybrid,
        init_idx=rows, init_dist=dist, init_valid=valid,
        visited=visited, best_dist=best, best_idx=besti,
        n_dist=n_new, cascade=cascade, qc=qc, init_ub=ub, n_esc=n_esc0)
    if sync:
        _sync(r.pool_idx)
        stats.expand_seconds += time.perf_counter() - t0
    else:
        # the loops are host-stepped: the host waited on the device inside
        # them (the reference, dispatching them whole, waits at the fetch)
        stats.wait_seconds += time.perf_counter() - t0

    ee = early_exit_enabled(tcfg)
    keep, dist2, n_amb, seed_ids, seed_valid, nds, ndt = _finalize_wave(
        cascade, qc, merged.vecs, xw, r.pool_idx, r.pool_dist, r.n_pool, lv,
        r.best_idx, th2, cap=capctl.cap, dist_impl=tcfg.dist_impl,
        early_exit=ee)
    lsp.end(lanes=int(np.count_nonzero(lane_valid)), cap=capctl.cap,
            hybrid=hybrid)
    h = WaveHandles(
        qids=qids, lane_valid=np.asarray(lane_valid), xw=xw,
        vecs=merged.vecs, cascade=cascade, qc=qc, th2=th2,
        pool_idx=r.pool_idx, raw_pool_dist=r.pool_dist, n_pool=r.n_pool,
        best_idx=r.best_idx, n_dist=r.n_dist, n_esc=r.n_esc,
        overflow=r.overflow, n_iters=(r.n_iters,), keep=keep, dist=dist2,
        n_amb=n_amb, seed_ids=seed_ids, seed_valid=seed_valid,
        n_dims_scanned=nds, n_dims_total=ndt, capctl=capctl, cap=capctl.cap,
        dist_impl=tcfg.dist_impl, early_exit=ee, span=dspan)
    _count_band(h, stats)
    return h


def run_mi_join(X: torch.Tensor, merged: GraphIndex, cfg: JoinConfig,
                stats: JoinStats, all_pairs: list[np.ndarray], *,
                qid_offset: int = 0, cascade=None,
                capctl: RerankCap | None = None) -> None:
    """es_mi / es_mi_adapt join (greedy offloaded; BFS or adaptive BBFS).

    ``X`` (nq, d) is on the index's device; pair blocks are appended to
    ``all_pairs``. ``cascade`` compresses the merged index; pooled
    survivors are re-ranked exactly before emission. MI waves are mutually
    independent, so with overlap on the next wave is launched before the
    previous one is assembled (including across the BFS/BBFS group
    boundary).
    """
    nq = X.shape[0]
    n_data = merged.n_data
    dev = X.device

    # adaptive split: predict OOD once, vectorized (paper §4.5)
    t0 = time.perf_counter()
    if cfg.method == "es_mi_adapt":
        flags = []
        for q0 in range(0, nq, 4096):
            q1 = min(q0 + 4096, nq)
            qid = n_data + torch.arange(q0, q1, dtype=torch.int32, device=dev)
            flags.append(predict_ood(merged, X[q0:q1], qid,
                                     factor=cfg.ood_factor,
                                     impl=cfg.traversal.dist_impl).cpu())
        ood = (torch.cat(flags).numpy() if flags
               else np.zeros(0, bool))
        stats.n_ood = int(ood.sum())
    else:
        ood = np.zeros(nq, bool)
    groups = [(np.flatnonzero(~ood), False), (np.flatnonzero(ood), True)]
    stats.other_seconds += time.perf_counter() - t0

    if capctl is None:
        capctl = RerankCap(cfg.traversal)
    ov = overlap_enabled(cfg)
    pending: WaveHandles | None = None

    def drain(h: WaveHandles) -> None:
        out = assemble_wave(h, stats, qid_offset=qid_offset)
        all_pairs.append(out.pairs)

    for ids_all, hybrid in groups:
        for c0 in range(0, ids_all.size, cfg.wave_size):
            wave = ids_all[c0:c0 + cfg.wave_size]
            qids, lane_valid = pad_wave(wave, cfg.wave_size)
            xw = X[torch.as_tensor(qids, device=dev)]
            qc = cascade.encode(xw) if cascade is not None else None
            h = launch_mi_wave(merged, xw, qids, lane_valid, cfg, stats,
                               hybrid=hybrid, cascade=cascade, qc=qc,
                               capctl=capctl, sync=not ov)
            if ov:
                if pending is not None:
                    drain(pending)
                pending = h
            else:
                drain(h)
    if pending is not None:
        drain(pending)


# ---------------------------------------------------------------------------
# search-path waves (index / es / es_hws / es_sws)
# ---------------------------------------------------------------------------

def effective_tcfg(cfg: JoinConfig) -> TraversalConfig:
    """The INDEX baseline is ES with early stopping disabled."""
    tcfg = cfg.traversal
    if cfg.method == "index" and tcfg.patience >= 0:
        tcfg = dataclasses.replace(tcfg, patience=-1)
    return tcfg


def launch_search_wave(index_y: GraphIndex, xw: torch.Tensor,
                       qids: np.ndarray, lane_valid: np.ndarray,
                       cfg: JoinConfig, stats: JoinStats, *,
                       seeds: np.ndarray, seeds_valid: np.ndarray,
                       cascade=None, qc=None,
                       capctl: RerankCap | None = None, sync: bool = True,
                       collect_seeds: bool = False) -> WaveHandles:
    """The device phase of one search wave (Alg. 1 online): greedy search
    from the (B, S) ``seeds`` the caller filled from its work-sharing
    cache, range expansion from the greedy beam and visited bitmap, and
    the epilogue (band re-rank under a cascade; with ``collect_seeds`` the
    method's seed feedback). With ``sync`` the greedy and expansion phases
    are timed separately (the sequential path)."""
    tcfg = effective_tcfg(cfg)
    dev = xw.device
    if capctl is None:
        capctl = RerankCap(tcfg)
    tr = obs_trace.tracer()
    lsp = tr.span("wave/launch", lane="assembly")
    lv = torch.as_tensor(lane_valid, device=dev)
    seeds_t = torch.as_tensor(seeds, device=dev).to(torch.int32)
    sv = torch.as_tensor(seeds_valid, device=dev) & lv[:, None]
    if cascade is not None and qc is None:
        qc = cascade.encode(xw)
    th2 = traversal.sq_theta(cfg.theta)

    dspan = tr.begin("wave/device", lane="traversal", cap=capctl.cap)
    t0 = time.perf_counter()
    g = traversal.greedy_search(
        index_y, xw, seeds_t, sv, cfg.theta, cfg=tcfg,
        n_data=index_y.n_data, traverse_nondata=True, cascade=cascade, qc=qc)
    if sync:
        _sync(g.beam_dist)
        stats.greedy_seconds += time.perf_counter() - t0
        t0 = time.perf_counter()

    r = traversal.range_expand(
        index_y, xw, cfg.theta, cfg=tcfg, n_data=index_y.n_data,
        hybrid=False, traverse_nondata=True, init_idx=g.beam_idx,
        init_dist=g.beam_dist,
        init_valid=(g.beam_idx != NO_NODE) & torch.isfinite(g.beam_dist),
        visited=g.visited, best_dist=g.best_dist, best_idx=g.best_idx,
        n_dist=g.n_dist, cascade=cascade, qc=qc, n_esc=g.n_esc)
    if sync:
        _sync(r.pool_idx)
        stats.expand_seconds += time.perf_counter() - t0
    else:
        # host-stepped loops: see launch_mi_wave
        stats.wait_seconds += time.perf_counter() - t0

    seed_mode = cfg.method if collect_seeds else "none"
    ee = early_exit_enabled(tcfg)
    keep, dist, n_amb, seed_ids, seed_valid, nds, ndt = _finalize_wave(
        cascade, qc, index_y.vecs, xw, r.pool_idx, r.pool_dist, r.n_pool,
        lv, r.best_idx, th2, cap=capctl.cap, dist_impl=tcfg.dist_impl,
        seed_mode=seed_mode, seeds_max=tcfg.seeds_max, early_exit=ee)
    lsp.end(lanes=int(np.count_nonzero(lane_valid)), cap=capctl.cap)
    h = WaveHandles(
        qids=qids, lane_valid=np.asarray(lane_valid), xw=xw,
        vecs=index_y.vecs, cascade=cascade, qc=qc, th2=th2,
        pool_idx=r.pool_idx, raw_pool_dist=r.pool_dist, n_pool=r.n_pool,
        best_idx=r.best_idx, n_dist=r.n_dist, n_esc=r.n_esc,
        overflow=r.overflow, n_iters=(g.n_iters, r.n_iters), keep=keep,
        dist=dist, n_amb=n_amb, seed_ids=seed_ids, seed_valid=seed_valid,
        n_dims_scanned=nds, n_dims_total=ndt, capctl=capctl, cap=capctl.cap,
        dist_impl=tcfg.dist_impl, seed_mode=seed_mode,
        seeds_max=tcfg.seeds_max, early_exit=ee, span=dspan)
    _count_band(h, stats)
    return h


def run_search_wave(index_y: GraphIndex, xw: torch.Tensor, qids: np.ndarray,
                    lane_valid: np.ndarray, cfg: JoinConfig,
                    stats: JoinStats, *, seeds: np.ndarray,
                    seeds_valid: np.ndarray, cascade=None,
                    qc=None) -> WaveOutput:
    """One padded search wave run in sequence (launch, then fetch, then
    assemble): the single-wave unit the pipelined runners are built
    from."""
    h = launch_search_wave(index_y, xw, qids, lane_valid, cfg, stats,
                           seeds=seeds, seeds_valid=seeds_valid,
                           cascade=cascade, qc=qc, sync=True)
    return assemble_wave(h, stats)


def update_sws_cache(cache: dict[int, np.ndarray], out: WaveOutput,
                     qids: np.ndarray, cfg: JoinConfig,
                     stats: JoinStats, cache_n: int) -> int:
    """SelectDataToCache (Alg. 3): HWS caches the whole kept pool, SWS the
    single closest node. Returns the updated entry count.

    HWS entries are ordered by the total (dist, id) key, the key the
    device-side seed feedback sorts by, so a pipelined wave seeds from
    exactly the prefix of the entry this writes."""
    if cfg.method == "es_hws":
        for i, q in enumerate(qids):
            if not out.lane_valid[i]:
                continue
            old = cache.get(int(q))
            if old is not None:          # overwrite evicts the old entry
                stats.cache_evictions += 1
                cache_n -= int(old.size)
            ids = out.pool_idx[i][out.pool_keep[i]]
            o = np.lexsort((ids, out.pool_dist[i][out.pool_keep[i]]))
            cache[int(q)] = ids[o]
            cache_n += int(ids.size)
    elif cfg.method == "es_sws":
        for i, q in enumerate(qids):
            if not out.lane_valid[i]:
                continue
            if int(q) in cache:
                stats.cache_evictions += 1
                cache_n -= 1
            b = int(out.best_idx[i])
            cache[int(q)] = (np.asarray([b], np.int32) if b != NO_NODE
                             else np.empty(0, np.int32))
            cache_n += 1
    stats.peak_cache_entries = max(stats.peak_cache_entries, cache_n)
    return cache_n


def seeds_from_cache(qids: np.ndarray, lane_valid: np.ndarray,
                     parent: np.ndarray | dict[int, int], cache, sy: int,
                     wave_size: int, seeds_max: int,
                     stats: JoinStats | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Seed lanes from their parents' cache entries (Alg. 1 lines 5–9),
    s_Y otherwise. ``parent`` maps a query id to its parent's (an array
    indexed by id, or the streaming engine's dict, where a missing id has
    none). ``cache`` is any mapping qid → id array (the pipelined runners
    pass ``ChainMap(seed_overlay, cache)``). With ``stats`` every lane with
    a parent counts as a cache hit (a non-empty entry) or a miss (it fell
    back to s_Y)."""
    seeds = np.full((wave_size, seeds_max), sy, np.int32)
    seeds_valid = np.zeros((wave_size, seeds_max), bool)
    seeds_valid[:, 0] = True
    get = (parent.get if isinstance(parent, dict)
           else lambda q: int(parent[q]))
    for i, q in enumerate(qids):
        p = get(int(q)) if lane_valid[i] else -1
        p = -1 if p is None else int(p)
        if p < 0:
            continue
        c = cache.get(p)
        if c is not None and c.size > 0:
            k = min(seeds_max, c.size)
            seeds[i, :k] = c[:k]
            seeds_valid[i, :k] = True
            if stats is not None:
                stats.cache_hits += 1
        elif stats is not None:
            stats.cache_misses += 1
    return seeds, seeds_valid


def run_search_join(X: torch.Tensor, index_y: GraphIndex,
                    index_x: GraphIndex | None, cfg: JoinConfig,
                    stats: JoinStats, all_pairs: list[np.ndarray], *,
                    cascade=None, capctl: RerankCap | None = None) -> None:
    """Full-batch index / es / es_hws / es_sws join (greedy + BFS).

    The caching methods run in MST wavefronts over ``index_x``, so a
    query's parent is complete before it starts; the others in query
    order. With overlap on, wave k+1 is launched from wave k's seed
    feedback (one small blocking fetch) before wave k is assembled; the
    host updates the work-sharing cache one wave behind and drops each
    overlay entry once the full entry is written, so the cache contents,
    the pairs and the counters equal the sequential path's."""
    nq = X.shape[0]
    dev = X.device
    needs_mst = cfg.method in ("es_hws", "es_sws")
    sy = int(index_y.start)

    t0 = time.perf_counter()
    if needs_mst:
        parent = ordering.mst_order(index_x, index_y.vecs[sy])
        waves = ordering.wavefronts(parent, cfg.wave_size)
    else:
        parent = np.full(nq, -1, np.int64)
        waves = [np.arange(c0, min(c0 + cfg.wave_size, nq))
                 for c0 in range(0, nq, cfg.wave_size)]
    stats.other_seconds += time.perf_counter() - t0

    S = cfg.traversal.seeds_max
    cache: dict[int, np.ndarray] = {}
    cache_n = 0
    overlay: dict[int, np.ndarray] = {}
    seed_cache = collections.ChainMap(overlay, cache)
    if capctl is None:
        capctl = RerankCap(effective_tcfg(cfg))
    ov = overlap_enabled(cfg)
    pending: WaveHandles | None = None

    def drain(h: WaveHandles) -> None:
        nonlocal cache_n
        out = assemble_wave(h, stats)
        all_pairs.append(out.pairs)
        t1 = time.perf_counter()
        with obs_trace.tracer().span("wave/cache_update", lane="assembly"):
            cache_n = update_sws_cache(cache, out, h.qids, cfg, stats,
                                       cache_n)
            for q in h.qids[h.lane_valid]:
                overlay.pop(int(q), None)
        stats.other_seconds += time.perf_counter() - t1

    for wave in waves:
        qids, lane_valid = pad_wave(wave, cfg.wave_size)
        xw = X[torch.as_tensor(qids, device=dev)]
        t0 = time.perf_counter()
        seeds, seeds_valid = seeds_from_cache(
            qids, lane_valid, parent, seed_cache, sy, cfg.wave_size, S,
            stats=stats)
        stats.other_seconds += time.perf_counter() - t0
        # the seed feedback only bridges the one-wave gap the pipeline
        # opens; the sequential path writes the cache before the next wave
        h = launch_search_wave(index_y, xw, qids, lane_valid, cfg, stats,
                               seeds=seeds, seeds_valid=seeds_valid,
                               cascade=cascade, capctl=capctl,
                               sync=not ov, collect_seeds=needs_mst and ov)
        if ov and pending is not None:
            drain(pending)
            pending = None
        if needs_mst and ov:
            overlay.update(fetch_feedback(h, stats))
        if ov:
            pending = h
        else:
            drain(h)
    if pending is not None:
        drain(pending)
