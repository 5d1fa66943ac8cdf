"""JoinEngine — a persistent join service over one data side Y (port of
``repro.engine.engine`` for the single-device f32 path).

The engine holds Y on its device and builds each index artifact once:
the data index G_Y (for the search-path methods ``index``, ``es``,
``es_hws``, ``es_sws``), and per query set (keyed by a content fingerprint
of X, kept in small LRUs) the query index G_X (the MST order of
``es_hws``/``es_sws``) and the merged index G_{X∪Y} (``es_mi``,
``es_mi_adapt``). Joins and threshold sweeps are served from them;
``build_counts`` shows the reuse.

Supported here: every method, every quant mode (``off``, ``sq8``,
``sketch8``, ``pdx8``, ``sketchpdx8``; for joins and, through
``build_kw["quant"]``, the cascade-driven index builds), one shard.
Streaming (``submit``) and sharding raise ``NotImplementedError`` naming
the ROADMAP slice that brings them.

Each tier store of an index artifact (int8, sketch, PDX) is built once
(``tier_store``, counted in ``build_counts["quant"]`` / ``["sketch"]`` /
``["pdx"]``) and shared by the artifact's cascade-driven build and by
every join served from it under any mode: a sketch8 join reuses the int8
store an sq8 join built.

``device=None`` means the CUDA card; without one the constructor raises
rather than run on the CPU (pass ``device="cpu"`` for the plain versions).
All f32 matrix products are full IEEE f32 (TF32 off, see
``core.types.resolve_device``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict
from typing import Any

import numpy as np
import torch

from repro_torch.core.types import (GraphIndex, JoinConfig, JoinResult,
                                    JoinStats, early_exit_enabled,
                                    resolve_device)
from repro_torch.engine import waves as W
from repro_torch.obs import metrics as obs_metrics

_MI_METHODS = ("es_mi", "es_mi_adapt")
_CACHING_METHODS = ("es_hws", "es_sws")

# ~64 KiB of content sampled per fingerprint (see repro.engine.engine)
_FP_SAMPLE_BYTES = 1 << 16


def _fingerprint(a) -> str:
    """Content hash of a vector set — the cache key for per-X artifacts.

    Hashes shape/dtype/nbytes plus a fixed-size strided byte sample (head
    and tail included), exactly as the reference does, so one array gets
    the same key in both packages. Two arrays that agree on every sampled
    byte collide; callers with sparse row edits to huge query sets should
    ``adopt`` their indexes or use a fresh engine."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(a))
    h = hashlib.sha1()
    h.update(repr((a.shape, str(a.dtype), a.nbytes)).encode())
    flat = a.reshape(-1).view(np.uint8) if a.size else a.reshape(-1)
    if flat.nbytes <= _FP_SAMPLE_BYTES:
        h.update(flat.tobytes())
    else:
        # odd stride: samples cycle through every byte offset of an element
        stride = (flat.nbytes // _FP_SAMPLE_BYTES) | 1
        h.update(np.ascontiguousarray(flat[::stride]).tobytes())
        h.update(flat[:2048].tobytes())
        h.update(flat[-2048:].tobytes())
    return h.hexdigest()[:16]


class _LRU(OrderedDict):
    def __init__(self, cap: int):
        super().__init__()
        self.cap = cap

    def touch(self, key):
        if key in self:
            self.move_to_end(key)
            return self[key]
        return None

    def put(self, key, value):
        self[key] = value
        self.move_to_end(key)
        while len(self) > self.cap:
            self.popitem(last=False)


class JoinEngine:
    """Persistent join service over one data side Y.

    Parameters
    ----------
    Y : (N, d) data vectors (numpy or tensor), copied to ``device`` as f32.
    build_kw : kwargs forwarded to ``graph.build_index`` (``k``,
        ``degree``, ``style``, ...).
    default : the ``JoinConfig`` used when a call supplies none.
    n_shards : must be 1 (multi-GPU is ROADMAP Queue A slice 13).
    max_cached_indexes : LRU capacity for per-X merged indexes.
    metrics : an ``obs.Metrics`` registry to publish every join into.
    device : where Y, the indexes and the joins live; ``None`` = the card.
    """

    def __init__(self, Y, *, build_kw: dict | None = None,
                 default: JoinConfig | None = None, n_shards: int = 1,
                 max_cached_indexes: int = 4,
                 metrics: obs_metrics.Metrics | None = None, device=None):
        if n_shards != 1:
            raise NotImplementedError(
                "sharded execution (n_shards != 1) arrives with the "
                "multi-GPU slice (ROADMAP Queue A slice 13)")
        self.device = resolve_device(device)
        if isinstance(Y, torch.Tensor):
            self.Y = Y.to(device=self.device, dtype=torch.float32).contiguous()
        else:
            self.Y = torch.as_tensor(np.asarray(Y, np.float32),
                                     device=self.device)
        self.build_kw = dict(build_kw or {})
        self.default = default or JoinConfig()
        self.n_shards = 1
        self.metrics = metrics if metrics is not None else \
            obs_metrics.metrics()
        self._index_y: GraphIndex | None = None
        self._index_x = _LRU(max_cached_indexes)
        self._merged = _LRU(max_cached_indexes)
        # compressed tier stores mirror the index artifacts they compress,
        # keyed by (tier name, artifact kind[, X fingerprint])
        self._tier_stores = _LRU(4 * max_cached_indexes)
        self.build_counts: dict[str, int] = {
            "index_y": 0, "index_x": 0, "merged": 0, "quant": 0,
            "sketch": 0, "pdx": 0}
        self.build_seconds = 0.0
        self.serve_stats: dict[str, int] = {
            "joins": 0, "queries": 0, "pairs": 0}

    # -- index lifecycle ----------------------------------------------------

    @property
    def n_index_builds(self) -> int:
        return sum(self.build_counts.values())

    def _cache_event(self, kind: str, hit: bool) -> None:
        self.metrics.counter(
            f"engine.cache.{kind}.{'hit' if hit else 'miss'}").inc()

    def _as_x(self, X) -> torch.Tensor:
        if isinstance(X, torch.Tensor):
            return X.to(device=self.device, dtype=torch.float32).contiguous()
        return torch.as_tensor(np.asarray(X, np.float32), device=self.device)

    def _build_kw_for(self, key: tuple, vecs) -> dict:
        """``build_kw`` with a ``quant`` mode resolved to a cascade over
        the artifact's cached int8 tier store, so the cascade-driven build
        and the joins served from that artifact share one store. The build
        consults only an int8 tier: a mode without one (pdx8, sketchpdx8)
        builds in f32, as ``graph.build_index`` maps it."""
        from repro_torch.quant.cascade import TIERS_BY_MODE, make_cascade
        bk = dict(self.build_kw)
        mode = bk.pop("quant", None)
        if mode and "int8" in TIERS_BY_MODE[mode]:
            bk["quant"] = make_cascade(
                [("int8", self.tier_store(key, "int8", vecs))])
        return bk

    def _build(self, kind: str, key: tuple, vecs, **kw) -> GraphIndex:
        """One index build over ``vecs`` for artifact ``key``, timed and
        counted in ``build_counts[kind]``."""
        from repro_torch.core import graph
        t0 = time.perf_counter()
        index = graph.build_index(vecs, **kw,
                                  **self._build_kw_for(key, vecs))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.build_seconds += time.perf_counter() - t0
        self.build_counts[kind] += 1
        return index

    def index_y(self) -> GraphIndex:
        """The data index G_Y (built once, reused by every search-path
        join; its tier stores are keyed ``("index_y",)``)."""
        self._cache_event("index_y", self._index_y is not None)
        if self._index_y is None:
            self._index_y = self._build("index_y", ("index_y",), self.Y)
        return self._index_y

    def index_x(self, X) -> GraphIndex:
        """The query index G_X (the MST order of the HWS/SWS methods)."""
        fp = _fingerprint(X)
        hit = self._index_x.touch(fp)
        self._cache_event("index_x", hit is not None)
        if hit is None:
            hit = self._build("index_x", ("index_x", fp), self._as_x(X))
            self._index_x.put(fp, hit)
        return hit

    def merged_index(self, X) -> GraphIndex:
        """Merged index G_{X∪Y} (greedy phase offloaded, paper §4.4)."""
        fp = _fingerprint(X)
        hit = self._merged.touch(fp)
        self._cache_event("merged", hit is not None)
        if hit is None:
            hit = self._build("merged", ("merged", fp),
                              torch.cat([self.Y, self._as_x(X)], dim=0),
                              n_data=int(self.Y.shape[0]))
            self._merged.put(fp, hit)
        return hit

    def tier_store(self, key: tuple, tier_name: str, vecs):
        """The compressed store behind one cascade tier of one index
        artifact (built once, LRU'd). ``key`` names the artifact
        (``("y",)``, ``("index_y",)``, ``("index_x", fp)`` or
        ``("merged", fp)``); ``vecs`` is its f32 table."""
        from repro_torch.quant.cascade import build_tier_store, tier_class

        ck = (tier_name,) + key
        hit = self._tier_stores.touch(ck)
        self._cache_event("tier_store", hit is not None)
        if hit is None:
            t0 = time.perf_counter()
            hit = build_tier_store(tier_name, vecs)
            self.build_seconds += time.perf_counter() - t0
            self.build_counts[tier_class(tier_name).build_counter] += 1
            self._tier_stores.put(ck, hit)
        return hit

    def cascade_for(self, key: tuple, vecs, cfg: JoinConfig,
                    stats: JoinStats):
        """The ``FilterCascade`` of one index artifact under ``cfg.quant``
        (None for quant off); ``stats.quant_bytes`` adds what is
        resident."""
        from repro_torch.quant.cascade import TIERS_BY_MODE, make_cascade

        if cfg.quant == "off":
            return None
        names = TIERS_BY_MODE[cfg.quant]
        casc = make_cascade([(n, self.tier_store(key, n, vecs))
                             for n in names])
        stats.quant_bytes += casc.nbytes
        return casc

    def adopt(self, *, index_y: GraphIndex | None = None, X=None,
              index_x: GraphIndex | None = None,
              index_merged: GraphIndex | None = None,
              tier_stores: dict | None = None) -> None:
        """Install prebuilt indexes (G_Y; G_X and the merged index of
        ``X``) and prebuilt tier stores (``{tier name: store}``, for
        example carried across from the reference with
        ``quant.*_store_from_numpy``): over the merged index of ``X`` when
        ``X`` is given, else over Y (the NLJ's artifact). Nothing adopted
        counts as a build."""
        if index_y is not None:
            self._index_y = index_y
        for name, index in (("index_x", index_x),
                            ("index_merged", index_merged)):
            if index is not None and X is None:
                raise ValueError(f"adopting {name} requires X")
        if index_x is not None:
            self._index_x.put(_fingerprint(X), index_x)
        if index_merged is not None:
            self._merged.put(_fingerprint(X), index_merged)
        key = ("merged", _fingerprint(X)) if X is not None else ("y",)
        for name, store in (tier_stores or {}).items():
            self._tier_stores.put((name,) + key, store)

    # -- configuration ------------------------------------------------------

    def _resolve(self, cfg: JoinConfig | None, method: str | None,
                 theta: float | None) -> JoinConfig:
        cfg = cfg or self.default
        rep: dict[str, Any] = {}
        if method is not None:
            rep["method"] = method
        if theta is not None:
            rep["theta"] = float(theta)
        return dataclasses.replace(cfg, **rep) if rep else cfg

    # -- one-shot joins -----------------------------------------------------

    def join(self, X, cfg: JoinConfig | None = None, *,
             method: str | None = None, theta: float | None = None,
             index_y: GraphIndex | None = None,
             index_x: GraphIndex | None = None,
             index_merged: GraphIndex | None = None) -> JoinResult:
        """Join X against the engine's Y. Cached indexes are reused;
        whatever the method needs and is missing is built (and counted).
        ``cfg.quant`` filters through the cascade over the method's index
        artifact (G_Y for the search path, G_{X∪Y} for the MI methods, Y
        for the NLJ)."""
        from repro_torch.core.join import cascade_join_pairs

        cfg = self._resolve(cfg, method, theta)
        Xd = self._as_x(X)
        stats = JoinStats()
        if any(i is not None for i in (index_y, index_x, index_merged)):
            self.adopt(index_y=index_y, X=X, index_x=index_x,
                       index_merged=index_merged)

        if cfg.method == "nlj":
            t0 = time.perf_counter()
            casc = self.cascade_for(("y",), self.Y, cfg, stats)
            pairs, counts = cascade_join_pairs(
                Xd, self.Y, cfg.theta, casc, impl=cfg.traversal.dist_impl,
                early_exit=early_exit_enabled(cfg.traversal))
            stats.n_rerank = counts["n_rerank"]
            if counts["escalated"]:
                stats.n_esc8 = counts["escalated"][0]
            stats.n_dims_scanned += counts["dims_scanned"]
            stats.n_dims_total += counts["dims_total"]
            stats.other_seconds = time.perf_counter() - t0
            stats.n_dist = int(Xd.shape[0]) * int(self.Y.shape[0])
            return self._done(JoinResult(pairs=pairs, stats=stats), Xd)

        all_pairs: list[np.ndarray] = []
        t0 = time.perf_counter()
        if cfg.method in _MI_METHODS:
            merged = self.merged_index(X)
            casc = self.cascade_for(("merged", _fingerprint(X)), merged.vecs,
                                    cfg, stats)
            stats.other_seconds += time.perf_counter() - t0
            W.run_mi_join(Xd, merged, cfg, stats, all_pairs, cascade=casc)
        else:
            iy = self.index_y()
            ix = self.index_x(X) if cfg.method in _CACHING_METHODS else None
            casc = self.cascade_for(("index_y",), iy.vecs, cfg, stats)
            stats.other_seconds += time.perf_counter() - t0
            W.run_search_join(Xd, iy, ix, cfg, stats, all_pairs,
                              cascade=casc)
        pairs = (np.concatenate(all_pairs, axis=0) if all_pairs
                 else np.empty((0, 2), np.int64))
        return self._done(JoinResult(pairs=pairs, stats=stats), Xd)

    def sweep(self, X, thetas, cfg: JoinConfig | None = None, *,
              method: str | None = None) -> list[JoinResult]:
        """Threshold sweep: one index build amortized over all thetas."""
        return [self.join(X, cfg, method=method, theta=float(t))
                for t in thetas]

    def submit(self, X_batch, cfg: JoinConfig | None = None, **kw):
        """Streaming joins are not ported yet."""
        raise NotImplementedError(
            "streaming submit arrives with the streaming engine slice "
            "(ROADMAP Queue A slice 6)")

    # -- bookkeeping --------------------------------------------------------

    def _done(self, result: JoinResult, X) -> JoinResult:
        self.serve_stats["joins"] += 1
        self.serve_stats["queries"] += int(X.shape[0])
        self.serve_stats["pairs"] += len(result.pairs)
        result.stats.publish(self.metrics)
        self.metrics.counter("engine.joins").inc()
        self.metrics.counter("engine.queries").inc(int(X.shape[0]))
        self.metrics.counter("engine.pairs").inc(len(result.pairs))
        return result

