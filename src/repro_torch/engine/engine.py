"""JoinEngine — a persistent join service over one data side Y (port of
``repro.engine.engine``).

The engine holds Y on its device and builds each index artifact once:
the data index G_Y (for the search-path methods ``index``, ``es``,
``es_hws``, ``es_sws``), and per query set (keyed by a content fingerprint
of X, kept in small LRUs) the query index G_X (the MST order of
``es_hws``/``es_sws``) and the merged index G_{X∪Y} (``es_mi``,
``es_mi_adapt``). Joins and threshold sweeps are served from them;
``build_counts`` shows the reuse.

Supported here: every method, every quant mode (``off``, ``sq8``,
``sketch8``, ``pdx8``, ``sketchpdx8``; for joins and, through
``build_kw["quant"]``, the cascade-driven index builds), and streaming:
``submit(X_batch)`` joins a batch under *global* query ids and, for the
work-sharing methods, carries the cache of completed queries across
batches (each new query seeds from the cache entry of the nearest query
in the carry window); ``submit_many`` pipelines consecutive search
batches across their boundaries.

Sharding: with ``n_shards > 1`` the data side is split over the devices
of a ``core.distributed.DeviceMesh`` (core/distributed.py): the MI
methods join against one merged index per shard, ``nlj`` runs the mesh
NLJ (hybrid dimension+vector partitioning where ``MeshPlan`` picks it).
``X ⋈_θ Y = ∪_s (X ⋈_θ Y_s)`` holds exactly. The mesh is the caller's
(``mesh``; several shards may share one device) or the plan's over the
visible CUDA devices; asking for more shards than that raises a clear
``ValueError``. The search methods run on one device.

``plan_config`` and ``plan_request`` pick operating points through the
engine's ``plan.JoinPlanner`` (the LSH estimate and the cost table of
finished joins); ``metrics_snapshot`` and ``cumulative_stats`` read the
metrics registry every join is published into; ``drop_caches`` releases
the index artifacts and tier stores (a serving tenant's unload).

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
from collections import ChainMap, OrderedDict
from typing import Any

import numpy as np
import torch

from repro_torch.core import distributed
from repro_torch.core.types import (QUANT_FILTER_MODES, QUANT_MODES,
                                    GraphIndex, JoinConfig, JoinResult,
                                    JoinStats, early_exit_enabled,
                                    resolve_device)
from repro_torch.engine import waves as W
from repro_torch.kernels import ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.plan.cost import CostTable

_MI_METHODS = ("es_mi", "es_mi_adapt")
_SEARCH_METHODS = ("index", "es", "es_hws", "es_sws")
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


def _host(X) -> np.ndarray:
    """A query batch as a host f32 array (tensors copied off their device)."""
    if isinstance(X, torch.Tensor):
        return X.detach().to("cpu", torch.float32).numpy()
    return np.asarray(X, np.float32)


def _pairs(parts: list[np.ndarray]) -> np.ndarray:
    return (np.concatenate(parts, axis=0) if parts
            else np.empty((0, 2), np.int64))


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
    n_shards : > 1 splits Y into that many shards (the MI methods join
        against one merged index per shard, ``nlj`` runs the mesh NLJ);
        0 means one shard per device of ``mesh``, else per visible CUDA
        device (one on the CPU). More shards than devices raise a clear
        ``ValueError`` at the first sharded join.
    mesh, shard_axes : a ``DeviceMesh`` to run the shards on (it wins over
        the planned mesh; ``DeviceMesh.on_device("cpu", n)`` puts n
        shards on the CPU) and the axis (or axes) the shards lie along.
    carry_window : how many completed queries the streaming path keeps
        as seed donors for later batches.
    max_cached_indexes : LRU capacity for per-X artifacts (query index,
        merged index, sharded index).
    metrics : an ``obs.Metrics`` registry to publish every join into.
    device : where Y, the indexes and the joins live; ``None`` = the card
        (the mesh's first device when a ``mesh`` is given).
    """

    def __init__(self, Y, *, build_kw: dict | None = None,
                 default: JoinConfig | None = None, n_shards: int = 1,
                 mesh: distributed.DeviceMesh | None = None,
                 shard_axes=("data",), carry_window: int = 4096,
                 max_cached_indexes: int = 4,
                 metrics: obs_metrics.Metrics | None = None, device=None):
        if device is None and mesh is not None:
            device = mesh.devices[0]
        self.device = resolve_device(device)
        if isinstance(Y, torch.Tensor):
            self.Y = Y.to(device=self.device, dtype=torch.float32).contiguous()
        else:
            self.Y = torch.as_tensor(np.asarray(Y, np.float32),
                                     device=self.device)
        self.build_kw = dict(build_kw or {})
        self.default = default or JoinConfig()
        self._mesh = mesh
        self._shard_axes = shard_axes
        self.n_shards = int(n_shards) if n_shards else (
            mesh.axis_size(shard_axes) if mesh is not None
            else max(distributed.visible_devices(self.device), 1))
        self._plans: dict[bool, distributed.MeshPlan] = {}
        self._nlj_steps: dict = {}       # the mesh NLJ's step and Y blocks
        self.carry_window = int(carry_window)
        self.metrics = metrics if metrics is not None else \
            obs_metrics.metrics()
        self._index_y: GraphIndex | None = None
        self._index_x = _LRU(max_cached_indexes)
        self._merged = _LRU(max_cached_indexes)
        self._sharded = _LRU(max_cached_indexes)
        # compressed tier stores mirror the index artifacts they compress
        # (one store a shard for the sharded index), keyed by (tier name,
        # artifact kind[, X fingerprint])
        self._tier_stores = _LRU(4 * max_cached_indexes)
        self.build_counts: dict[str, int] = {
            "index_y": 0, "index_x": 0, "merged": 0, "sharded": 0,
            "quant": 0, "sketch": 0, "pdx": 0}
        self.build_seconds = 0.0
        self.serve_stats: dict[str, int] = {
            "joins": 0, "batches": 0, "queries": 0, "pairs": 0}

        # streaming state (global query ids, carried work-sharing cache).
        # Under a quantized mode with an int8 tier the carry window holds
        # the donors' int8 codes and norms (host arrays), else f32 vectors
        self._stream_n = 0
        self._stream_cache: dict[int, np.ndarray] = {}
        self._stream_entry_n = 0         # cached ids, not cached queries
        self._carry_vecs: np.ndarray | None = None
        self._carry_codes: np.ndarray | None = None
        self._carry_norms: np.ndarray | None = None
        self._carry_qids = np.empty(0, np.int64)

        # the LSH estimator over Y (built on first use) and its band-cap
        # estimates, sticky per (θ, quant, pool cap); the cost table of
        # finished joins per (method, quant); the planner over both
        self._estimator = None
        self._planner = None
        self._cap_estimates: dict[tuple, int] = {}
        self.cost_table = CostTable()

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

    def sharded_index(self, X) -> distributed.ShardedMergedIndex:
        """Per-shard merged indexes G_{X∪Y_s}, shard s built on its mesh
        device (counted in ``build_counts["sharded"]``)."""
        fp = _fingerprint(X)
        hit = self._sharded.touch(fp)
        self._cache_event("sharded", hit is not None)
        if hit is None:
            mesh, axes, _ = self._traversal_mesh()
            t0 = time.perf_counter()
            hit = distributed.build_sharded_merged_index(
                self.Y, self._as_x(X), self.n_shards,
                devices=mesh.shard_devices(axes), **self.build_kw)
            for dev in set(hit.devices):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            self.build_seconds += time.perf_counter() - t0
            self.build_counts["sharded"] += 1
            self._sharded.put(fp, hit)
        return hit

    def tier_store(self, key: tuple, tier_name: str, vecs):
        """The compressed store behind one cascade tier of one index
        artifact (built once, LRU'd). ``key`` names the artifact
        (``("y",)``, ``("index_y",)``, ``("index_x", fp)``,
        ``("merged", fp)`` or ``("sharded", fp)``); ``vecs`` is its f32
        table, or for the sharded key the ``ShardedMergedIndex`` whose
        shards each get their own store (per-shard grids)."""
        from repro_torch.quant.cascade import build_tier_store, tier_class

        ck = (tier_name,) + key
        hit = self._tier_stores.touch(ck)
        self._cache_event("tier_store", hit is not None)
        if hit is None:
            t0 = time.perf_counter()
            if key[0] == "sharded":
                hit = distributed.build_sharded_tier(
                    tier_name, vecs, n_data=int(self.Y.shape[0]))
            else:
                hit = build_tier_store(tier_name, vecs)
            self.build_seconds += time.perf_counter() - t0
            self.build_counts[tier_class(tier_name).build_counter] += 1
            self._tier_stores.put(ck, hit)
        return hit

    def cascade_for(self, key: tuple, vecs, cfg: JoinConfig,
                    stats: JoinStats):
        """The ``FilterCascade`` (``ShardedCascade`` for the sharded key)
        of one index artifact under ``cfg.quant`` (None for quant off);
        ``stats.quant_bytes`` adds what is resident."""
        from repro_torch.quant.cascade import TIERS_BY_MODE, make_cascade

        if cfg.quant == "off":
            return None
        names = TIERS_BY_MODE[cfg.quant]
        stores = [(n, self.tier_store(key, n, vecs)) for n in names]
        if key[0] == "sharded":
            casc = distributed.ShardedCascade(
                names=tuple(n for n, _ in stores),
                stores=tuple(st for _, st in stores))
        else:
            casc = make_cascade(stores)
        stats.quant_bytes += casc.nbytes
        return casc

    def warm_quant(self, X, cfg: JoinConfig | None = None, *,
                   method: str | None = None) -> None:
        """Build the tier stores a join of ``X`` would use (nothing unless
        the resolved config names a filtering quant mode): over Y for the
        NLJ, over the merged index of ``X`` for the MI methods, over G_Y
        for the search path."""
        cfg = self._resolve(cfg, method, None)
        if cfg.quant not in QUANT_FILTER_MODES:
            return
        if cfg.method == "nlj":
            key, vecs = ("y",), self.Y
        elif self.n_shards > 1:
            key, vecs = ("sharded", _fingerprint(X)), self.sharded_index(X)
        elif cfg.method in _MI_METHODS:
            key, vecs = ("merged", _fingerprint(X)), self.merged_index(X).vecs
        else:
            key, vecs = ("index_y",), self.index_y().vecs
        self.cascade_for(key, vecs, cfg, JoinStats())

    def drop_caches(self) -> None:
        """Release every cached index artifact and tier store (the tenant
        unload path of ``serve.JoinService``). ``Y`` and the build
        counters stay; the next join rebuilds on demand."""
        self._index_y = None
        self._index_x.clear()
        self._merged.clear()
        self._sharded.clear()
        self._tier_stores.clear()
        self._nlj_steps.clear()    # the mesh NLJ's device-resident Y blocks
        self._plans.clear()

    def adopt(self, *, index_y: GraphIndex | None = None, X=None,
              index_x: GraphIndex | None = None,
              index_merged: GraphIndex | None = None,
              index_sharded: distributed.ShardedMergedIndex | None = None,
              tier_stores: dict | None = None) -> None:
        """Install prebuilt indexes (G_Y; G_X, the merged index and the
        per-shard merged indexes of ``X``) and prebuilt tier stores
        (``{tier name: store}``, for example carried across from the
        reference with ``quant.*_store_from_numpy``, or per shard as a
        ``distributed.ShardedTierStore``): over the sharded index of ``X``
        when one is adopted, else over the merged index of ``X`` when
        ``X`` is given, else over Y (the NLJ's artifact). Nothing adopted
        counts as a build."""
        if index_y is not None:
            self._index_y = index_y
        for name, index in (("index_x", index_x),
                            ("index_merged", index_merged),
                            ("index_sharded", index_sharded)):
            if index is not None and X is None:
                raise ValueError(f"adopting {name} requires X")
        if index_x is not None:
            self._index_x.put(_fingerprint(X), index_x)
        if index_merged is not None:
            self._merged.put(_fingerprint(X), index_merged)
        if index_sharded is not None:
            self._sharded.put(_fingerprint(X), index_sharded)
        key = (("sharded" if index_sharded is not None else "merged",
                _fingerprint(X)) if X is not None else ("y",))
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

    def _mesh_plan(self, *, traversal: bool) -> distributed.MeshPlan:
        """The engine's ``MeshPlan`` for (N_y, d, n_shards): vector
        partitioning for graph traversal, hybrid-eligible for the exact
        NLJ, over the devices of the engine's mesh (else the visible CUDA
        devices, one on the CPU). Raises the clear error when the shards
        outnumber them."""
        plan = self._plans.get(traversal)
        if plan is None:
            devices = (self._mesh.size if self._mesh is not None
                       else distributed.visible_devices(self.device))
            plan = distributed.MeshPlan.plan(
                int(self.Y.shape[0]), int(self.Y.shape[1]), self.n_shards,
                devices=devices, traversal=traversal)
            self._plans[traversal] = plan
        return plan

    def _traversal_mesh(self):
        """``(mesh, shard_axes, plan)`` of the sharded MI join: the
        caller's mesh when given (``plan`` None: all_gather combine), else
        the traversal plan's mesh over the visible CUDA devices."""
        if self._mesh is not None:
            return self._mesh, self._shard_axes, None
        plan = self._mesh_plan(traversal=True)
        return plan.make_mesh(), plan.data_axis, plan

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
        cfg = self._resolve(cfg, method, theta)
        Xd = self._as_x(X)
        stats = JoinStats()
        if any(i is not None for i in (index_y, index_x, index_merged)):
            self.adopt(index_y=index_y, X=X, index_x=index_x,
                       index_merged=index_merged)

        if cfg.method == "nlj":
            if self.n_shards > 1:
                return self._done(self._join_sharded_nlj(Xd, cfg, stats),
                                  Xd, cfg)
            return self._done(self._join_nlj(Xd, cfg, stats), Xd, cfg)
        if self.n_shards > 1:
            return self._done(self._join_sharded(X, cfg, stats), Xd, cfg)

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
        return self._done(JoinResult(pairs=_pairs(all_pairs), stats=stats),
                          Xd, cfg)

    def _join_nlj(self, Xd: torch.Tensor, cfg: JoinConfig,
                  stats: JoinStats) -> JoinResult:
        """The exact NLJ of ``Xd`` against Y through ``cfg.quant``'s
        cascade over Y (local query ids)."""
        from repro_torch.core.join import cascade_join_pairs
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
        return JoinResult(pairs=pairs, stats=stats)

    def sweep(self, X, thetas, cfg: JoinConfig | None = None, *,
              method: str | None = None) -> list[JoinResult]:
        """Threshold sweep: one index build amortized over all thetas."""
        return [self.join(X, cfg, method=method, theta=float(t))
                for t in thetas]

    def _join_sharded(self, X, cfg: JoinConfig,
                      stats: JoinStats) -> JoinResult:
        """The mesh MI join: Y split over the shards, waves replicated,
        the pair pools band-compacted and combined on the devices (one
        fused assembly transfer a wave). es_mi_adapt runs the hybrid BBFS
        for every query, as the reference does: a sound superset of the
        per-query split (per-shard OOD flags would need per-shard side
        tables)."""
        if cfg.method not in _MI_METHODS:
            raise NotImplementedError(
                f"sharded execution supports {_MI_METHODS} and 'nlj', not "
                f"{cfg.method!r} (work-sharing caches are per-device)")
        mesh, axes, plan = self._traversal_mesh()
        smi = self.sharded_index(X)
        casc = self.cascade_for(("sharded", _fingerprint(X)), smi, cfg,
                                stats)
        # the merge cap's seed: the LSH estimate of the per-shard band
        # (advisory; the driver's retry loop owns correctness). The re-rank
        # cap keeps its configured cold start, as in the reference.
        mcap0 = self.estimate_merge_cap(_host(X), cfg,
                                        limit=int(cfg.traversal.pool_cap))
        t0 = time.perf_counter()
        pairs, dstats = distributed.distributed_mi_join(
            self._as_x(X), smi, mesh, axes, theta=cfg.theta,
            cfg=cfg.traversal, wave_size=cfg.wave_size,
            hybrid=cfg.method == "es_mi_adapt", cascade=casc,
            n_data=int(self.Y.shape[0]), overlap=W.overlap_enabled(cfg),
            plan=plan, merge_cap=mcap0)
        # the driver times its fetches and assembly; the rest of its wall
        # clock (the host-stepped traversal) is expansion
        stats.expand_seconds += max(
            0.0, time.perf_counter() - t0
            - dstats.wait_seconds - dstats.other_seconds)
        stats = stats.merge(dstats)
        pairs = pairs[pairs[:, 1] < self.Y.shape[0]]   # sentinel rows
        return JoinResult(pairs=pairs, stats=stats)

    def _join_sharded_nlj(self, Xd: torch.Tensor, cfg: JoinConfig,
                          stats: JoinStats, offset: int = 0) -> JoinResult:
        """The mesh exact NLJ: the ``MeshPlan`` may move devices from the
        row axis to the dimension axis (hybrid partitioning, ``psum``
        combine). Distances are exact f32, so the pairs are the
        single-device NLJ's under every quant mode. The step, Y's blocks
        and the merge cap persist across calls (``_nlj_steps``): θ is a
        runtime argument, so streamed batches and sweeps reuse them."""
        plan = self._mesh_plan(traversal=False)
        # the merged pool holds exact-θ pairs: seed its cap from the
        # sampled true in-range counts, not the sketch-band superset
        mcap0 = self.estimate_merge_cap(_host(Xd), cfg,
                                        limit=int(self.Y.shape[0]),
                                        exact=True)
        t0 = time.perf_counter()
        pairs, dstats = distributed.distributed_nlj_join(
            Xd, self.Y, plan, theta=cfg.theta, wave_size=cfg.wave_size,
            step_cache=self._nlj_steps, merge_cap=mcap0, mesh=self._mesh,
            impl=cfg.traversal.dist_impl)
        stats.expand_seconds += max(
            0.0, time.perf_counter() - t0
            - dstats.wait_seconds - dstats.other_seconds)
        stats = stats.merge(dstats)
        if offset:
            pairs = pairs.copy()
            pairs[:, 0] += offset
        return JoinResult(pairs=pairs, stats=stats)

    # -- streaming ----------------------------------------------------------

    @property
    def n_submitted(self) -> int:
        return self._stream_n

    def reset_stream(self) -> None:
        """Forget every streamed query: global ids restart at 0 and the
        work-sharing cache and carry window are dropped."""
        self._stream_n = 0
        self._stream_cache.clear()
        self._stream_entry_n = 0
        self._carry_vecs = None
        self._carry_codes = None
        self._carry_norms = None
        self._carry_qids = np.empty(0, np.int64)

    def submit(self, X_batch, cfg: JoinConfig | None = None, *,
               method: str | None = None,
               theta: float | None = None) -> JoinResult:
        """Join one streaming batch; result pairs carry *global* query ids
        (``n_submitted`` at call time + local position).

        The batch is padded into waves. For ``es_sws``/``es_hws`` the
        work-sharing cache persists across calls: each query seeds from
        the cache entry of the nearest previously completed query in the
        carry window instead of s_Y (the streaming form of the paper's MST
        parent order). An MI batch builds (and caches) the merged index of
        its own queries; under a filtering quant mode its band capacity is
        seeded from the LSH estimate (``estimate_rerank_cap``)."""
        cfg = self._resolve(cfg, method, theta)
        if self.n_shards > 1 and cfg.method in _SEARCH_METHODS:
            raise NotImplementedError(
                "sharded streaming supports 'nlj' and the merged-index "
                "methods; the work-sharing-cache methods "
                f"{_SEARCH_METHODS} run single-device (n_shards=1)")
        Xd = self._as_x(X_batch)
        nb = int(Xd.shape[0])
        offset = self._stream_n
        stats = JoinStats()

        if cfg.method == "nlj" and self.n_shards > 1:
            result = self._join_sharded_nlj(Xd, cfg, stats, offset)
        elif cfg.method in _MI_METHODS and self.n_shards > 1:
            result = self._join_sharded(X_batch, cfg, stats)
            result.pairs[:, 0] += offset
        elif cfg.method == "nlj":
            result = self._join_nlj(Xd, cfg, stats)
            result.pairs[:, 0] += offset
        elif cfg.method in _MI_METHODS:
            # the merged index must contain the batch's query nodes, so MI
            # streaming pays one (cached, fingerprint-keyed) build per
            # distinct batch
            all_pairs: list[np.ndarray] = []
            merged = self.merged_index(X_batch)
            casc = self.cascade_for(("merged", _fingerprint(X_batch)),
                                    merged.vecs, cfg, stats)
            W.run_mi_join(Xd, merged, cfg, stats, all_pairs,
                          qid_offset=offset, cascade=casc,
                          capctl=self._seeded_capctl(X_batch, cfg))
            result = JoinResult(pairs=_pairs(all_pairs), stats=stats)
        else:
            result = self._submit_search_group(
                [(_host(X_batch), cfg, stats, offset)])[0]

        self._stream_n = offset + nb
        self._batch_done(result, nb, cfg)
        return result

    def _batch_done(self, result: JoinResult, nb: int,
                    cfg: JoinConfig) -> None:
        self.serve_stats["batches"] += 1
        self.serve_stats["queries"] += nb
        self.serve_stats["pairs"] += len(result.pairs)
        result.stats.publish(self.metrics)
        self.metrics.counter("engine.batches").inc()
        self.metrics.counter("engine.queries").inc(nb)
        self.metrics.counter("engine.pairs").inc(len(result.pairs))
        self._observe_cost(cfg, nb, result.stats)

    def submit_many(self, jobs) -> list[JoinResult]:
        """Submit several streaming batches; returns one ``JoinResult``
        per job, pair-identical to calling ``submit`` on each in order.

        ``jobs`` is a sequence of ``(X_batch, cfg)`` pairs (``cfg`` None
        for the engine default). Consecutive search-path jobs that agree
        on (method, quant, wave_size) and have the wave pipeline on run as
        one pipelined group: the last wave of batch k stays in flight
        while batch k+1's first wave launches from its seed feedback. The
        feedback entries equal the prefix of the full cache entry, so the
        pairs and the work-sharing cache are those of sequential
        ``submit`` calls. NLJ and merged-index jobs run through
        ``submit``."""
        resolved = [(X, self._resolve(cfg, None, None)) for X, cfg in jobs]
        results: list[JoinResult] = []
        i = 0
        while i < len(resolved):
            X, cfg = resolved[i]
            if not (cfg.method in _SEARCH_METHODS
                    and W.overlap_enabled(cfg) and self.n_shards == 1):
                results.append(self.submit(X, cfg))
                i += 1
                continue
            key = (cfg.method, cfg.quant, cfg.wave_size)
            j = i + 1
            while j < len(resolved):
                c2 = resolved[j][1]
                if ((c2.method, c2.quant, c2.wave_size) != key
                        or not W.overlap_enabled(c2)):
                    break
                j += 1
            group = []
            for X2, c2 in resolved[i:j]:
                X2 = _host(X2)
                group.append((X2, c2, JoinStats(), self._stream_n))
                self._stream_n += int(X2.shape[0])
            outs = self._submit_search_group(group)
            for (X2, c2, _, _), res in zip(group, outs):
                self._batch_done(res, int(X2.shape[0]), c2)
            results.extend(outs)
            i = j
        return results

    def _submit_search_group(self, group) -> list[JoinResult]:
        """Streaming search-path waves over one or several batches.

        ``group`` is a list of ``(X_batch, cfg, stats, offset)`` jobs
        (host f32 batches) that share (method, quant, wave_size). Waves
        are double-buffered as in ``waves.run_search_join``: wave k+1 is
        launched from wave k's seed feedback while wave k is assembled,
        across batch boundaries too. Each wave's donors join the carry
        window before the next wave picks its parents (they need only the
        wave's queries or codes, not its traversal); a donor evicted
        before its cache entry landed becomes a tombstone of its wave,
        and the entry is dropped when the wave drains. With overlap off
        the same primitives run in sequence; pairs, stats and the cache
        are the same either way."""
        iy = self.index_y()
        sy = int(iy.start)
        all_pairs: list[list[np.ndarray]] = [[] for _ in group]
        # seed overlay: feedback entries of the wave whose full cache
        # update is still pending (the first S ids update_sws_cache writes)
        overlay: dict[int, np.ndarray] = {}
        seed_cache = ChainMap(overlay, self._stream_cache)
        pending: tuple[int, W.WaveHandles] | None = None

        def drain(j: int, h: W.WaveHandles) -> None:
            _, cfg_j, stats_j, _ = group[j]
            out = W.assemble_wave(h, stats_j)
            all_pairs[j].append(out.pairs)
            if cfg_j.method not in _CACHING_METHODS:
                return
            t1 = time.perf_counter()
            with obs_trace.tracer().span("wave/cache_update",
                                         lane="assembly"):
                self._stream_entry_n = W.update_sws_cache(
                    self._stream_cache, out, h.qids, cfg_j, stats_j,
                    self._stream_entry_n)
                for q in h.qids[h.lane_valid]:
                    overlay.pop(int(q), None)
                # donors evicted from the carry before their entry landed
                # (carry_window < wave_size): drop the entry now, as the
                # sequential update-then-evict order would have
                for q in h.tombstones:
                    gone = self._stream_cache.pop(int(q), None)
                    if gone is not None:
                        self._stream_entry_n -= len(gone)
                        stats_j.cache_tombstones += 1
            stats_j.other_seconds += time.perf_counter() - t1

        for j, (X_np, cfg, stats, offset) in enumerate(group):
            casc = self.cascade_for(("index_y",), iy.vecs, cfg, stats)
            int8 = casc.tier("int8") if casc is not None else None
            nb = int(X_np.shape[0])
            caching = cfg.method in _CACHING_METHODS
            ov = W.overlap_enabled(cfg)
            capctl = W.RerankCap(W.effective_tcfg(cfg),
                                 init_cap=self.estimate_rerank_cap(X_np, cfg))

            for c0 in range(0, nb, cfg.wave_size):
                local = np.arange(c0, min(c0 + cfg.wave_size, nb))
                qids_l, lane_valid = W.pad_wave(local, cfg.wave_size)
                qids_g = qids_l + offset
                # the wave is gathered on the host, then moved (wave, d)
                xw = torch.as_tensor(X_np[qids_l], device=self.device)
                # the queries are encoded once a wave: the codes drive the
                # parent choice, the carry window and the traversal
                qc = casc.encode(xw) if casc is not None else None
                qc8 = (qc[casc.names.index("int8")]
                       if int8 is not None else None)

                t0 = time.perf_counter()
                parent = self._assign_parents(X_np[qids_l], qc8, int8,
                                              qids_g, lane_valid, caching)
                seeds, seeds_valid = W.seeds_from_cache(
                    qids_g, lane_valid, parent, seed_cache, sy,
                    cfg.wave_size, cfg.traversal.seeds_max, stats=stats)
                stats.other_seconds += time.perf_counter() - t0

                h = W.launch_search_wave(iy, xw, qids_g, lane_valid, cfg,
                                         stats, seeds=seeds,
                                         seeds_valid=seeds_valid,
                                         cascade=casc, qc=qc,
                                         capctl=capctl, sync=not ov,
                                         collect_seeds=caching and ov)
                if ov and pending is not None:
                    drain(*pending)
                    pending = None
                if caching:
                    if ov:
                        overlay.update(W.fetch_feedback(h, stats))
                    # this wave's donors join the carry window before the
                    # next wave picks its parents; eviction may name
                    # queries whose entry is still pending (tombstones)
                    t0 = time.perf_counter()
                    lv = lane_valid
                    if qc8 is not None:
                        missed = self._remember(
                            None, qids_g[lv],
                            codes=qc8.q.cpu().numpy()[lv],
                            norms=qc8.norms.cpu().numpy()[lv], stats=stats)
                    else:
                        missed = self._remember(X_np[qids_l[lv]],
                                                qids_g[lv], stats=stats)
                    for q in missed:
                        overlay.pop(int(q), None)
                    h.tombstones.extend(missed)
                    stats.other_seconds += time.perf_counter() - t0
                if ov:
                    pending = (j, h)
                else:
                    drain(j, h)
        if pending is not None:
            drain(*pending)
        return [JoinResult(pairs=_pairs(ps), stats=group[j][2])
                for j, ps in enumerate(all_pairs)]

    # -- band-capacity estimates (plan.LshEstimator) -------------------------

    @property
    def estimator(self):
        """The engine's ``plan.LshEstimator`` over Y (built on first use:
        it samples and sketches ≤ 2,048 rows where Y lives)."""
        if self._estimator is None:
            from repro_torch.plan import LshEstimator
            self._estimator = LshEstimator(self.Y)
        return self._estimator

    @property
    def planner(self):
        """The engine's sticky ``plan.JoinPlanner`` (estimator + cost
        table + this engine's metrics registry)."""
        if self._planner is None:
            from repro_torch.plan import JoinPlanner
            self._planner = JoinPlanner(self.estimator, self.cost_table,
                                        metrics=self.metrics)
        return self._planner

    def estimate_rerank_cap(self, X_batch, cfg: JoinConfig) -> int | None:
        """LSH-sample estimate of the initial band-compaction capacity
        under a filtering quant mode (None otherwise): the covering power
        of two of the sampled max sketch-band occupancy with headroom,
        sticky per (θ, quant, pool cap). Emitted pairs never depend on
        it: a wave whose band overflows still grows the cap and retries."""
        tcfg = cfg.traversal
        if cfg.quant not in QUANT_FILTER_MODES or tcfg.rerank_cap <= 0:
            return None
        key = (round(float(cfg.theta), 6), cfg.quant, tcfg.pool_cap)
        cached = self._cap_estimates.get(key)
        if cached is not None:
            return cached
        t0 = time.perf_counter()
        est = self.estimator.estimate(X_batch, float(cfg.theta))
        cap = est.rerank_cap(tcfg.pool_cap)
        self._cap_estimates[key] = cap
        self.metrics.gauge(
            "engine.rerank_cap_estimate",
            help="LSH-sampled initial band capacity (last estimate)"
        ).set(cap)
        self.build_seconds += time.perf_counter() - t0
        return cap

    def _seeded_capctl(self, X_batch, cfg: JoinConfig) -> W.RerankCap:
        """A ``RerankCap`` seeded from the sticky LSH estimate (the config
        cold start for non-filtering modes)."""
        return W.RerankCap(cfg.traversal,
                           init_cap=self.estimate_rerank_cap(_host(X_batch),
                                                             cfg))

    def estimate_merge_cap(self, X_batch, cfg: JoinConfig, *, limit: int,
                           exact: bool = False) -> int:
        """LSH-sample seed of the sharded drivers' merged-pool cap: the
        predicted worst per-(query, shard) occupancy with headroom, sticky
        per (θ, shards, limit, exact). ``exact`` sizes it from the sampled
        true in-range counts (the mesh NLJ's pool holds only exact-θ
        pairs) instead of the sketch-band superset. Advisory: the drivers
        check for overflow and retry, so a low seed costs retries, never
        pairs."""
        key = (round(float(cfg.theta), 6), "merge", self.n_shards,
               int(limit), bool(exact))
        cached = self._cap_estimates.get(key)
        if cached is not None:
            return cached
        t0 = time.perf_counter()
        est = self.estimator.estimate(X_batch, float(cfg.theta),
                                      n_shards=self.n_shards)
        cap = est.merge_cap(int(limit), exact=exact)
        self._cap_estimates[key] = cap
        self.metrics.gauge(
            "engine.merge_cap_estimate",
            help="LSH-sampled sharded merge capacity (last estimate)"
        ).set(cap)
        self.build_seconds += time.perf_counter() - t0
        return cap

    # -- planning (plan.JoinPlanner) -----------------------------------------

    def plan_config(self, X_batch, cfg: JoinConfig | None = None, *,
                    method: str | None = None, theta: float | None = None,
                    quant: str | None = None) -> JoinConfig:
        """Plan one batch's operating point and return it as a concrete
        ``JoinConfig`` (``--plan auto``). Explicit ``method``/``quant`` pin
        those knobs; otherwise the planner picks among every method and
        quant mode by calibrated cost (the selectivity heuristic before
        calibration). The wave size snaps to the planner's bucket ladder
        (``planner.buckets``); the cap seeds flow through the sticky
        estimates at join time. A planned config joins through the same
        overflow-checked drivers as a hand-tuned one and emits the same
        pairs."""
        base = self._resolve(cfg, method, theta)
        if quant is not None:
            base = dataclasses.replace(base, quant=quant)
        if self.n_shards > 1:
            methods = ("nlj",) + _MI_METHODS
            default_method = "es_mi_adapt"
        else:
            methods = ("nlj",) + _SEARCH_METHODS + _MI_METHODS
            default_method = base.method if base.method != "nlj" else None
        p = self.planner.plan(
            _host(X_batch), theta=float(base.theta),
            pool_cap=int(base.traversal.pool_cap),
            method=method, quant=quant, methods=methods,
            quants=QUANT_MODES if quant is None else (quant,),
            default_method=default_method, default_quant=base.quant,
            n_shards=self.n_shards, dim=int(self.Y.shape[1]))
        out = dataclasses.replace(base, method=p.method, quant=p.quant,
                                  wave_size=p.wave_size)
        if (p.hybrid_patience is not None
                and p.method == "es_mi_adapt"
                and p.hybrid_patience != out.traversal.hybrid_patience):
            out = dataclasses.replace(out, traversal=dataclasses.replace(
                out.traversal, hybrid_patience=p.hybrid_patience))
        return out

    def plan_request(self, n_queries: int, *, theta: float,
                     method: str | None = None,
                     quant: str | None = None) -> tuple[str, str]:
        """Per-request (method, quant) for the serving admission path,
        from the cost table alone: planning a request never samples the
        estimator or touches the device. Before any calibration, the
        servable default (es_sws; nlj on a sharded engine) and the
        engine's default quant."""
        if self.n_shards > 1:
            servable, fallback = ("nlj",) + _MI_METHODS, "nlj"
        else:
            servable, fallback = ("nlj",) + _SEARCH_METHODS, "es_sws"
        methods = (method,) if method else servable
        quants = (quant,) if quant else (self.default.quant,)
        choice = self.planner.choose(int(n_queries), methods=methods,
                                     quants=quants)
        if choice is not None:
            return choice[0], choice[1]
        return (method or fallback), (quant or self.default.quant)

    # -- the carry window -----------------------------------------------------

    def _assign_parents(self, xw: np.ndarray, qc8, int8_tier,
                        qids_g: np.ndarray, lane_valid: np.ndarray,
                        caching: bool) -> dict[int, int]:
        """Streaming parent = the nearest completed query in the carry
        window (the first one at a tie).

        Under a mode with an int8 tier both sides are int8: the wave's
        codes (already encoded for the traversal) against the donors'
        codes and norms, padded to the full window, through the int8
        pairwise kernel on the engine's device; the padded columns are cut
        before the argmin. Otherwise the f32 product runs in numpy on the
        host, as in the reference, so the parents are the reference's.
        Parent choice is a seeding heuristic: nothing certifies it."""
        if not caching or not len(self._carry_qids):
            return {}
        if qc8 is not None and self._carry_codes is not None:
            st = int8_tier.store
            C, Nn = self._carry_codes, self._carry_norms
            ncar = C.shape[0]
            if ncar < self.carry_window:
                pad = self.carry_window - ncar
                C = np.concatenate(
                    [C, np.zeros((pad,) + C.shape[1:], C.dtype)])
                Nn = np.concatenate([Nn, np.zeros(pad, Nn.dtype)])
            dev = qc8.q.device
            d2 = ops.pairwise_sq_dists_int8(
                qc8.q, torch.as_tensor(C, device=dev), st.scales,
                group_size=st.group_size, xn=qc8.norms,
                yn=torch.as_tensor(Nn, device=dev)).cpu().numpy()[:, :ncar]
        elif self._carry_vecs is not None:
            C = self._carry_vecs
            d2 = (np.sum(xw * xw, axis=1, keepdims=True)
                  + np.sum(C * C, axis=1)[None, :] - 2.0 * xw @ C.T)
        else:
            # the carry holds the other representation (the quant mode
            # changed mid-stream): no parents for this wave
            return {}
        nearest = self._carry_qids[np.argmin(d2, axis=1)]
        return {int(q): int(p)
                for q, p, v in zip(qids_g, nearest, lane_valid) if v}

    def _remember(self, vecs: np.ndarray | None, qids: np.ndarray, *,
                  codes: np.ndarray | None = None,
                  norms: np.ndarray | None = None,
                  stats: JoinStats | None = None) -> list[int]:
        """Append donors to the carry window, evicting beyond capacity
        (an evicted donor's cache entry goes with it).

        Returns the evicted qids whose cache entry did not exist yet (the
        pipelined path appends donors before the wave's cache update
        lands; the caller turns them into tombstones)."""
        def _append(cur, new):
            if new is None:
                return cur
            return new.copy() if cur is None else np.concatenate([cur, new])

        missed: list[int] = []

        def _evict(qs) -> None:
            for q in qs:
                gone = self._stream_cache.pop(int(q), None)
                if gone is not None:
                    self._stream_entry_n -= len(gone)
                    if stats is not None:
                        stats.cache_evictions += 1
                else:
                    missed.append(int(q))

        # a mode switch mid-stream changes the carry representation (f32
        # vectors ↔ int8 codes): the window restarts, and the dropped
        # donors leave the cache as evicted ones do
        if (codes is not None) != (self._carry_codes is not None) \
                and len(self._carry_qids):
            _evict(self._carry_qids)
            self._carry_vecs = self._carry_codes = self._carry_norms = None
            self._carry_qids = np.empty(0, np.int64)
        self._carry_vecs = _append(self._carry_vecs, vecs)
        self._carry_codes = _append(self._carry_codes, codes)
        self._carry_norms = _append(self._carry_norms, norms)
        self._carry_qids = np.concatenate(
            [self._carry_qids, qids.astype(np.int64)])
        if len(self._carry_qids) > self.carry_window:
            keep = len(self._carry_qids) - self.carry_window
            _evict(self._carry_qids[:keep])
            for attr in ("_carry_vecs", "_carry_codes", "_carry_norms"):
                cur = getattr(self, attr)
                if cur is not None:
                    setattr(self, attr, cur[keep:])
            self._carry_qids = self._carry_qids[keep:]
        return missed

    # -- bookkeeping --------------------------------------------------------

    def _done(self, result: JoinResult, X, cfg: JoinConfig) -> JoinResult:
        self.serve_stats["joins"] += 1
        self.serve_stats["queries"] += int(X.shape[0])
        self.serve_stats["pairs"] += len(result.pairs)
        result.stats.publish(self.metrics)
        self.metrics.counter("engine.joins").inc()
        self.metrics.counter("engine.queries").inc(int(X.shape[0]))
        self.metrics.counter("engine.pairs").inc(len(result.pairs))
        self._observe_cost(cfg, int(X.shape[0]), result.stats)
        return result

    def metrics_snapshot(self) -> dict:
        """Plain-dict dump of the engine's metrics registry (cumulative
        ``join.*`` stats, ``engine.cache.*`` hits and misses, serve
        counters, the ambient wave histograms on the default registry),
        plus the planner's cost table under ``"cost_table"``."""
        snap = self.metrics.snapshot()
        ct = self.cost_table.snapshot()
        if ct:
            snap["cost_table"] = ct
        return snap

    def cumulative_stats(self) -> JoinStats:
        """Engine-lifetime ``JoinStats``, materialized back from the
        metrics registry every join was published into."""
        return JoinStats.from_metrics(self.metrics)

    def _observe_cost(self, cfg: JoinConfig, n_queries: int,
                      stats: JoinStats) -> None:
        """Offer a finished join to the cost table (the fastest per-query
        measurement per (method, quant) wins)."""
        if self.cost_table.observe(cfg.method, cfg.quant, n_queries,
                                   stats):
            self.metrics.counter(
                "plan.calibrations",
                help="cost-table entries (re)calibrated from finished "
                     "joins").inc()

