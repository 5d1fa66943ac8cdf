"""Wave runners for the merged-index join (port of ``repro.engine.waves``).

Queries are processed in waves of ``JoinConfig.wave_size`` lanes; a short
final wave is padded with invalid lanes that are masked throughout. Each
wave has a device phase (``launch_mi_wave``: probe the query's own
merged-index row, then BFS / hybrid BBFS) and a host phase
(``assemble_wave``: one device→host transfer of the pool block, then pair
assembly). With overlap on, wave k+1 is launched before wave k is
assembled, the reference's launch → launch → assemble order; pair sets
are identical either way.

The traversal loop is host-stepped (one sync per iteration), so the
device is mostly idle while the host assembles: the overlap keeps the
reference's order and stats rather than hiding host time. A second CUDA
stream with pinned non-blocking copies is later work.

The search-path waves (``index``/``es``/``es_hws``/``es_sws``) arrive with
ROADMAP Queue A slice 5, the quantized re-rank with slices 7–9.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import traversal
from repro_torch.core.ood import predict_ood
from repro_torch.core.types import (NO_NODE, GraphIndex, JoinConfig,
                                    JoinStats, TraversalConfig, env_flag)
from repro_torch.kernels import ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

_INF = float("inf")


def overlap_enabled(cfg: JoinConfig) -> bool:
    """``cfg.overlap``, unless the ``REPRO_OVERLAP`` env var overrides it."""
    return env_flag("REPRO_OVERLAP", cfg.overlap)


next_pow2 = ops.next_pow2


class StickyCap:
    """Sticky power-of-two grow-and-retry capacity (see
    ``repro.engine.waves.StickyCap``)."""

    def __init__(self, init: int, limit: int):
        self.limit = limit
        self.cap = min(next_pow2(max(init, 1)), limit)

    def grow(self, needed: int) -> None:
        self.cap = ops.grow_cap(self.cap, needed, self.limit)


class RerankCap(StickyCap):
    """``StickyCap`` for the ambiguous-band re-rank, sized from the
    traversal config. The f32 path has no band; the quantized slices
    use it."""

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

def _finalize_wave(pool_idx: torch.Tensor, pool_dist: torch.Tensor,
                   n_pool: torch.Tensor, lane_valid: torch.Tensor):
    """Device epilogue of one exact-f32 wave (the reference's
    ``_finalize_wave`` with ``cascade=None``, ``seed_mode="none"``): every
    filled pool slot of a valid lane is emitted.

    Returns ``(keep (B, C), dist (B, C) — +inf off keep, n_amb (B,))``."""
    B, C = pool_idx.shape
    keep = ((torch.arange(C, device=pool_idx.device)[None, :] < n_pool[:, None])
            & lane_valid[:, None])
    dist = torch.where(keep, pool_dist, _INF)
    n_amb = torch.zeros((B,), dtype=torch.int32, device=pool_idx.device)
    return keep, dist, n_amb


@dataclasses.dataclass
class WaveHandles:
    """One in-flight wave: device handles plus host-side bookkeeping."""
    qids: np.ndarray               # (B,) global query ids
    lane_valid: np.ndarray         # (B,) bool
    xw: torch.Tensor               # (B, d) wave queries (device)
    pool_idx: torch.Tensor
    n_pool: torch.Tensor
    best_idx: torch.Tensor
    n_dist: torch.Tensor
    overflow: torch.Tensor
    n_iters: tuple                 # host ints, summed at assembly
    keep: torch.Tensor
    dist: torch.Tensor
    n_amb: torch.Tensor
    capctl: RerankCap
    # device-phase trace span ("traversal" lane), opened at dispatch and
    # closed at the first host contact with the results (_resolve_band)
    span: object = None
    n_amb_host: np.ndarray | None = None


def _resolve_band(h: WaveHandles, stats: JoinStats) -> None:
    """First host contact with a wave: fetch its band occupancy (always 0
    on the exact path, which never re-ranks) and close the device span."""
    if h.n_amb_host is not None:
        return
    t0 = time.perf_counter()
    with obs_trace.tracer().span("wave/band", lane="assembly"):
        n_amb = h.n_amb.cpu().numpy()
    max_amb = int(n_amb.max()) if n_amb.size else 0
    if h.span:
        h.span.end(band_occ=max_amb, cap=h.capctl.cap)
    h.n_amb_host = n_amb
    stats.wait_seconds += time.perf_counter() - t0
    stats.bytes_feedback += n_amb.nbytes
    obs_metrics.metrics().histogram(
        "wave.band_occ", help="per-wave max ambiguous-band occupancy"
    ).observe(max_amb)


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
        (pool_idx, pool_dist, keep, n_pool, best_idx, n_dist,
         overflow) = (t.cpu().numpy() for t in (
             h.pool_idx, h.dist, h.keep, h.n_pool, h.best_idx, h.n_dist,
             h.overflow))
        lv = h.lane_valid
        pairs = collect_pairs(h.qids + qid_offset, keep, pool_idx)
        stats.n_dist += int(n_dist[lv].sum())
        stats.n_overflow += int(overflow[lv].sum())
        stats.n_rerank += int(h.n_amb_host[lv].sum())
        stats.n_iters += sum(h.n_iters)
        stats.bytes_assembly += (
            pool_idx.nbytes + pool_dist.nbytes + keep.nbytes + n_pool.nbytes
            + best_idx.nbytes + n_dist.nbytes + overflow.nbytes)
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
              dist_impl: str | None):
    """Probe each query's own neighborhood row in the merged index."""
    B = x.shape[0]
    W = traversal.bitmap_words(merged.n_nodes)
    visited = torch.zeros((B, W), dtype=torch.int32, device=x.device)
    # mark the query's own node visited so traversal never loops back
    visited.scatter_add_(1, (qids >> 5).long()[:, None],
                         traversal.bit_of(qids)[:, None])
    rows = merged.nbrs[qids.long()]                          # (B, R)
    valid = lane_valid[:, None].expand(rows.shape)
    dist, valid, visited, n_new = traversal._probe(
        merged.vecs, x, rows, valid, visited, n_data=merged.n_data,
        traverse_nondata=traverse_nondata, dist_impl=dist_impl)
    best, arg = torch.min(dist, dim=1)
    besti = torch.gather(torch.where(valid, rows, NO_NODE), 1,
                         arg[:, None])[:, 0]
    return rows, dist, valid, visited, n_new, best, besti


# ---------------------------------------------------------------------------
# merged-index waves (es_mi / es_mi_adapt)
# ---------------------------------------------------------------------------

def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def launch_mi_wave(merged: GraphIndex, xw: torch.Tensor, qids: np.ndarray,
                   lane_valid: np.ndarray, cfg: JoinConfig,
                   stats: JoinStats, *, hybrid: bool,
                   capctl: RerankCap | None = None,
                   sync: bool = True) -> WaveHandles:
    """The device phase of one merged-index wave (probe + BFS/BBFS
    expansion + epilogue). With ``sync`` the probe and expansion phases
    are timed separately (the sequential path)."""
    tcfg = cfg.traversal
    dev = xw.device
    n_data = merged.n_data
    node_ids = torch.as_tensor(qids, device=dev).to(torch.int32) + n_data
    lv = torch.as_tensor(lane_valid, device=dev)
    if capctl is None:
        capctl = RerankCap(tcfg)
    tr = obs_trace.tracer()
    lsp = tr.span("wave/launch", lane="assembly")

    dspan = tr.begin("wave/device", lane="traversal", cap=capctl.cap)
    t0 = time.perf_counter()
    rows, dist, valid, visited, n_new, best, besti = _mi_probe(
        merged, xw, node_ids, lv, traverse_nondata=hybrid,
        dist_impl=tcfg.dist_impl)
    if sync:
        _sync(dist)
        stats.greedy_seconds += time.perf_counter() - t0
        t0 = time.perf_counter()

    r = traversal.range_expand(
        merged, xw, cfg.theta, cfg=tcfg, n_data=n_data,
        hybrid=hybrid, traverse_nondata=hybrid,
        init_idx=rows, init_dist=dist, init_valid=valid,
        visited=visited, best_dist=best, best_idx=besti,
        n_dist=n_new)
    if sync:
        _sync(r.pool_idx)
        stats.expand_seconds += time.perf_counter() - t0

    keep, dist2, n_amb = _finalize_wave(r.pool_idx, r.pool_dist, r.n_pool,
                                        lv)
    lsp.end(lanes=int(np.count_nonzero(lane_valid)), cap=capctl.cap,
            hybrid=hybrid)
    return WaveHandles(
        qids=qids, lane_valid=np.asarray(lane_valid), xw=xw,
        pool_idx=r.pool_idx, n_pool=r.n_pool, best_idx=r.best_idx,
        n_dist=r.n_dist, overflow=r.overflow,
        n_iters=(r.n_iters,), keep=keep, dist=dist2, n_amb=n_amb,
        capctl=capctl, span=dspan)


def run_mi_join(X: torch.Tensor, merged: GraphIndex, cfg: JoinConfig,
                stats: JoinStats, all_pairs: list[np.ndarray], *,
                qid_offset: int = 0,
                capctl: RerankCap | None = None) -> None:
    """es_mi / es_mi_adapt join (greedy offloaded; BFS or adaptive BBFS).

    ``X`` (nq, d) is on the index's device; pair blocks are appended to
    ``all_pairs``. MI waves are mutually independent, so with overlap on
    the next wave is launched before the previous one is assembled
    (including across the BFS/BBFS group boundary).
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
            h = launch_mi_wave(merged, xw, qids, lane_valid, cfg, stats,
                               hybrid=hybrid, capctl=capctl, sync=not ov)
            if ov:
                if pending is not None:
                    drain(pending)
                pending = h
            else:
                drain(h)
    if pending is not None:
        drain(pending)
