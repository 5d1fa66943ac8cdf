"""JoinService — continuous-batching admission front end for JoinEngine
(port of ``repro.serve.join_service``).

Requests from many tenants enter one admission ``deque``, each carrying
its own operating point (θ, method, quant mode, recall budget); the
service buckets each request onto a fixed ladder of wave sizes, groups a
serving round per tenant, and dispatches through
``JoinEngine.submit_many`` so waves from back-to-back batches stay
interleaved in the engine's double-buffered pipeline.

Admission discipline, as in the reference:

  * every request's ``wave_size`` is snapped to a ladder bucket
    (``ServiceConfig.buckets``, sorted ascending; pad-to-next inside the
    engine's ``pad_wave``), so wave shapes come from a fixed set;
  * per-request recall budgets are snapped to quarter steps and map to
    *patience scaling only*;
  * the initial band-compaction capacity comes from the engine's sticky
    LSH-sample estimate (``estimate_rerank_cap``);
  * requests that leave ``method``/``quant`` unspecified are planned by
    the tenant engine's cost table (``JoinEngine.plan_request``), which
    never samples the estimator or touches the device;
  * ``warmup()`` runs one synthetic batch per (bucket × operating point),
    which also seeds the sticky cap estimates, and then
    ``reset_stream()``s; ``obs.metrics.compile_count()`` (the port's
    kernel-library builds) must stay flat from there on.

Tenancy: ``load()``/``unload()`` manage per-tenant ``JoinEngine``s in LRU
order, capped at ``max_tenants``; eviction calls
``JoinEngine.drop_caches()`` so the tenant's index artifacts and tier
stores are released, not just unlinked. Tenant engines run on the CUDA
card unless ``engine_kw`` names a ``device``.

Backpressure surfaces through the registry (``_MetricsDict`` over
``serve_join.*`` gauges, admission-latency and occupancy histograms,
TraceKit spans per round and tenant batch); a full queue or an invalid
request is recorded as failed through ``RequestRejected`` — admission
never raises into the serving loop. A sharded tenant serves ``nlj``
(a planned merged-index method becomes ``nlj`` there); a search method
on it is rejected, for the search path runs on one device.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.types import (METHODS, QUANT_MODES, JoinConfig,
                                    JoinStats, env_flag)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.engine import RequestRejected, _MetricsDict

_BUDGET_STEPS = (0.25, 0.5, 0.75, 1.0)

# Not servable through the streaming front end: merged-index methods
# rebuild their index per batch.
_UNSERVABLE = ("es_mi", "es_mi_adapt")
# No sharded submit path: the search methods run on one device.
_SINGLE_DEVICE = ("index", "es", "es_hws", "es_sws")


def snap_budget(budget: float) -> float:
    """Snap a recall budget to the quarter-step grid (clamped to
    [0.25, 1])."""
    b = min(max(float(budget), _BUDGET_STEPS[0]), _BUDGET_STEPS[-1])
    return min(_BUDGET_STEPS, key=lambda s: abs(s - b))


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Admission-side knobs (engine-side knobs live on each tenant's
    ``JoinConfig`` default).

    buckets     — sorted ladder of wave sizes; a request of n queries is
                  served at the smallest bucket ≥ n (the largest bucket,
                  in multiple waves, beyond the ladder top).
    max_queue   — admission queue capacity; submits beyond it are
                  rejected (recorded as failed, ``rejected`` counter).
    max_tenants — loaded-engine LRU capacity; eviction drops the
                  evicted tenant's cached index artifacts.
    interleave  — dispatch per-tenant rounds through ``submit_many``;
                  off serializes ``submit`` per request. The
                  ``REPRO_SERVE_INTERLEAVE`` env var overrides it.
    """
    buckets: tuple[int, ...] = (64, 128, 256)
    max_queue: int = 256
    max_tenants: int = 4
    interleave: bool = True

    def __post_init__(self):
        if not self.buckets or list(self.buckets) != sorted(self.buckets) \
                or min(self.buckets) <= 0:
            raise ValueError(
                f"buckets must be a non-empty ascending ladder of "
                f"positive wave sizes, got {self.buckets!r}")


@dataclasses.dataclass
class JoinRequest:
    """One tenant request: join ``X`` (numpy or a tensor) against the
    tenant's Y at its own operating point. ``method``/``quant`` left as
    None route the request through the tenant engine's planner; ``wave``
    pins the ladder bucket it must run at (a wave off the ladder is
    rejected, not snapped)."""
    uid: int
    tenant: str
    X: np.ndarray                   # (n, d) query vectors
    theta: float
    method: str | None = None       # None → planner picks
    quant: str | None = None        # None → planner picks
    wave: int | None = None         # None → snapped to the ladder
    recall_budget: float = 1.0      # snapped to quarters → patience scale


@dataclasses.dataclass
class ServedJoin:
    """Result envelope: the engine's pairs/stats plus serving metadata."""
    uid: int
    tenant: str
    pairs: np.ndarray
    stats: JoinStats
    bucket: int                     # ladder wave size the request ran at
    admit_seconds: float            # enqueue → dispatch
    qid_offset: int = 0             # global stream id of the request's
    n_queries: int = 0              # first query (pairs carry global ids)
    ok: bool = True

    def pair_set(self) -> set:
        return set(map(tuple, np.asarray(self.pairs).tolist()))

    def pair_set_local(self) -> set:
        """Pairs with the query side rebased to request-local ids."""
        return {(a - self.qid_offset, b) for a, b in self.pair_set()}


class JoinService:
    def __init__(self, cfg: ServiceConfig | None = None, *,
                 metrics: obs_metrics.Metrics | None = None):
        self.cfg = cfg or ServiceConfig()
        self.metrics = metrics if metrics is not None else \
            obs_metrics.metrics()
        self.interleave = env_flag("REPRO_SERVE_INTERLEAVE",
                                   self.cfg.interleave)
        self._tenants: OrderedDict[str, object] = OrderedDict()
        self.queue: collections.deque = collections.deque()
        self.done: dict[int, ServedJoin] = {}
        self.failed: dict[int, str] = {}
        self.stats = _MetricsDict(
            self.metrics, "serve_join", admitted=0, completed=0,
            rejected=0, batches=0, queue_depth=0, tenants=0,
            tenant_evictions=0)
        self._h_admit = self.metrics.histogram(
            "serve_join.admission_seconds",
            buckets=obs_metrics.LATENCY_BUCKETS,
            help="enqueue → dispatch latency per request")
        self._h_occ = self.metrics.histogram(
            "serve_join.occupancy", buckets=(0.25, 0.5, 0.75, 1.0),
            help="fraction of padded wave lanes carrying real queries")
        obs_metrics.enable_compile_counter()

    # -- tenant registry ----------------------------------------------------

    def load(self, tenant: str, Y, *, build_kw: dict | None = None,
             default: JoinConfig | None = None,
             engine_kw: dict | None = None):
        """Load (or touch) a tenant: builds its ``JoinEngine`` on the
        service's metrics registry (on the card unless ``engine_kw`` names
        a device; a tensor already there is kept, not copied) and
        LRU-tracks it. Beyond ``max_tenants`` the least-recently-served
        tenant is evicted and its cached index artifacts dropped."""
        from repro_torch.engine.engine import JoinEngine

        eng = self._tenants.get(tenant)
        if eng is None:
            eng = JoinEngine(Y, build_kw=build_kw, default=default,
                             metrics=self.metrics, **(engine_kw or {}))
            self._tenants[tenant] = eng
        self._tenants.move_to_end(tenant)
        while len(self._tenants) > self.cfg.max_tenants:
            name, old = self._tenants.popitem(last=False)
            old.drop_caches()
            self.stats["tenant_evictions"] += 1
            obs_trace.tracer().instant("serve_join/tenant_evict",
                                       lane="serve", tenant=name)
        self.stats["tenants"] = len(self._tenants)
        return eng

    def unload(self, tenant: str) -> bool:
        """Drop a tenant and release its engine's artifact caches.
        Returns False for an unknown tenant."""
        eng = self._tenants.pop(tenant, None)
        if eng is None:
            return False
        eng.drop_caches()
        self.stats["tenants"] = len(self._tenants)
        return True

    def engine(self, tenant: str):
        """The tenant's loaded ``JoinEngine`` (LRU-touched)."""
        if tenant not in self._tenants:
            raise KeyError(f"tenant {tenant!r} not loaded")
        self._tenants.move_to_end(tenant)
        return self._tenants[tenant]

    @property
    def tenants(self) -> list[str]:
        return list(self._tenants)

    # -- planning -----------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        """Smallest ladder bucket ≥ n (ladder top beyond it)."""
        for b in self.cfg.buckets:
            if b >= n:
                return b
        return self.cfg.buckets[-1]

    def plan(self, req: JoinRequest) -> JoinConfig:
        """The exact ``JoinConfig`` a request will run under — public so
        a caller can replay the service's planning against a direct
        ``JoinEngine.submit``. Unspecified ``method``/``quant`` go through
        the tenant engine's ``plan_request`` (cost table only). Raises
        ``RequestRejected`` when a pinned ``wave`` is not on the ladder."""
        eng = self.engine(req.tenant)
        base = eng.default
        method, quant = req.method, req.quant
        if method is None or quant is None:
            method, quant = eng.plan_request(
                len(req.X), theta=float(req.theta),
                method=method, quant=quant)
            if method in _UNSERVABLE:
                method = "nlj" if eng.n_shards > 1 else "es_sws"
        wave = (int(req.wave) if req.wave is not None
                else self.bucket_for(len(req.X)))
        if wave not in self.cfg.buckets:
            raise RequestRejected(
                f"uid={req.uid}: wave {wave} does not fit any "
                f"pre-compiled bucket {self.cfg.buckets}")
        rep: dict = dict(method=method, theta=float(req.theta),
                         quant=quant, wave_size=wave)
        b = snap_budget(req.recall_budget)
        if b < 1.0 and base.traversal.patience >= 0:
            rep["traversal"] = dataclasses.replace(
                base.traversal,
                patience=max(1, round(base.traversal.patience * b)))
        return dataclasses.replace(base, **rep)

    # -- admission ----------------------------------------------------------

    def validate(self, req: JoinRequest) -> None:
        """Admission validation — raises ``RequestRejected``."""
        if req.tenant not in self._tenants:
            raise RequestRejected(
                f"uid={req.uid}: tenant {req.tenant!r} not loaded")
        X = req.X if isinstance(req.X, torch.Tensor) else np.asarray(req.X)
        if X.ndim != 2 or X.shape[0] == 0:
            raise RequestRejected(
                f"uid={req.uid}: X must be a non-empty (n, d) array, "
                f"got shape {tuple(X.shape)}")
        d = int(self._tenants[req.tenant].Y.shape[1])
        if int(X.shape[1]) != d:
            raise RequestRejected(
                f"uid={req.uid}: query dim {X.shape[1]} != tenant "
                f"{req.tenant!r} dim {d}")
        if not req.theta > 0:
            raise RequestRejected(f"uid={req.uid}: theta must be > 0")
        if req.method is not None:
            if req.method not in METHODS:
                raise RequestRejected(
                    f"uid={req.uid}: unknown method {req.method!r}")
            if req.method in _UNSERVABLE:
                raise RequestRejected(
                    f"uid={req.uid}: merged-index methods rebuild per "
                    "batch and are not servable through the streaming "
                    "front end")
            n_shards = self._tenants[req.tenant].n_shards
            if req.method in _SINGLE_DEVICE and n_shards > 1:
                raise RequestRejected(
                    f"uid={req.uid}: method {req.method!r} has no "
                    "sharded submit path and is not servable on a "
                    f"{n_shards}-shard tenant")
        if req.quant is not None and req.quant not in QUANT_MODES:
            raise RequestRejected(
                f"uid={req.uid}: unknown quant mode {req.quant!r}")
        if req.wave is not None and int(req.wave) not in self.cfg.buckets:
            raise RequestRejected(
                f"uid={req.uid}: wave {req.wave} does not fit any "
                f"pre-compiled bucket {self.cfg.buckets}")
        if req.uid in self.done or req.uid in self.failed \
                or any(r.uid == req.uid for r, _ in self.queue):
            raise RequestRejected(f"uid={req.uid}: duplicate uid")

    def _fail(self, req: JoinRequest, reason: str) -> None:
        self.done[req.uid] = ServedJoin(
            uid=req.uid, tenant=req.tenant,
            pairs=np.empty((0, 2), np.int64), stats=JoinStats(),
            bucket=0, admit_seconds=0.0, ok=False)
        self.failed[req.uid] = reason
        self.stats["rejected"] += 1
        obs_trace.tracer().instant("serve_join/reject", lane="serve",
                                   uid=req.uid, reason=reason)

    def submit(self, req: JoinRequest) -> bool:
        """Admit one request. Returns False (and records the request as
        failed) when validation rejects it or the queue is full —
        admission backpressure, not an exception."""
        try:
            self.validate(req)
        except RequestRejected as e:
            self._fail(req, str(e))
            return False
        if len(self.queue) >= self.cfg.max_queue:
            self._fail(req, f"queue full "
                            f"(max_queue={self.cfg.max_queue})")
            return False
        self.queue.append((req, time.perf_counter()))
        self.stats["admitted"] += 1
        self.stats["queue_depth"] = len(self.queue)
        return True

    # -- serving ------------------------------------------------------------

    def step(self) -> list[ServedJoin]:
        """Serve one admission round: drain the queue, group it per
        tenant (per-tenant FIFO order is kept; tenants are independent
        engines), and dispatch each tenant group through ``submit_many``."""
        if not self.queue:
            return []
        by_tenant: OrderedDict[str, list] = OrderedDict()
        while self.queue:
            req, t_enq = self.queue.popleft()
            by_tenant.setdefault(req.tenant, []).append((req, t_enq))
        self.stats["queue_depth"] = 0
        out: list[ServedJoin] = []
        with obs_trace.tracer().span("serve_join/round", lane="serve"):
            for tenant, items in by_tenant.items():
                out.extend(self._serve_tenant(tenant, items))
        return out

    def _serve_tenant(self, tenant: str, items: list) -> list[ServedJoin]:
        eng = self.engine(tenant)
        t_disp = time.perf_counter()
        offset = eng.n_submitted
        jobs, meta = [], []
        for req, t_enq in items:
            try:
                cfg = self.plan(req)
            except RequestRejected as e:     # late reject: recorded,
                self._fail(req, str(e))      # never raised into the loop
                continue
            b = cfg.wave_size
            n = len(req.X)
            self._h_admit.observe(t_disp - t_enq)
            self._h_occ.observe(n / (-(-n // b) * b))
            jobs.append((req.X, cfg))
            meta.append((req, t_disp - t_enq, b, offset))
            offset += n
        with obs_trace.tracer().span("serve_join/tenant_batch",
                                     lane="serve", tenant=tenant,
                                     n_requests=len(jobs)):
            if self.interleave:
                results = eng.submit_many(jobs)
            else:
                results = [eng.submit(X, cfg) for X, cfg in jobs]
        out = []
        for (req, admit_s, bucket, qid0), res in zip(meta, results):
            sj = ServedJoin(uid=req.uid, tenant=tenant, pairs=res.pairs,
                            stats=res.stats, bucket=bucket,
                            admit_seconds=admit_s, qid_offset=qid0,
                            n_queries=len(req.X))
            self.done[req.uid] = sj
            self.stats["completed"] += 1
            self.stats["batches"] += 1
            out.append(sj)
        return out

    def run(self) -> dict[int, ServedJoin]:
        """Serve until the admission queue is empty; uid → result."""
        while self.queue:
            self.step()
        return self.done

    # -- warmup -------------------------------------------------------------

    def warmup(self, tenant: str, *, thetas, methods=("es_sws",),
               quants=("off",), budgets=(1.0,), seed: int = 0) -> int:
        """Warm the bucket ladder for a tenant's operating points.

        Runs one two-wave synthetic batch per (bucket × θ × method × quant
        × budget) — two waves, so the second one runs the carry window's
        parent choice a first wave (empty carry) never reaches — which
        builds the tier stores and seeds the sticky re-rank cap estimates
        steady state will reuse, then ``reset_stream()``s the engine so
        the tenant's streaming state is untouched by warmup traffic. The
        synthetic queries are Y's mean (numpy's, over one host copy of Y)
        plus unit Gaussian noise. The ``REPRO_SERVE_WARMUP`` env flag
        gates it. Returns the number of warmup joins run."""
        if not env_flag("REPRO_SERVE_WARMUP", True):
            return 0
        eng = self.engine(tenant)
        d = int(eng.Y.shape[1])
        rng = np.random.default_rng(seed)
        mu = eng.Y.detach().cpu().numpy().mean(axis=0)
        n_run = 0
        with obs_trace.tracer().span("serve_join/warmup", lane="serve",
                                     tenant=tenant):
            for b in self.cfg.buckets:
                X = (mu[None, :]
                     + rng.normal(0, 1, (2 * b, d))).astype(np.float32)
                for method in methods:
                    for quant in quants:
                        for theta in thetas:
                            for budget in budgets:
                                req = JoinRequest(
                                    uid=-1, tenant=tenant, X=X[:b],
                                    theta=float(theta), method=method,
                                    quant=quant, recall_budget=budget)
                                eng.submit(X, self.plan(req))
                                n_run += 1
        eng.reset_stream()
        return n_run

    # -- observability ------------------------------------------------------

    def metrics_snapshot(self) -> dict:
        """Plain-dict dump of the service registry: ``serve_join.*``
        gauges/histograms, every tenant engine's published stats, and (on
        the process-global registry) the kernel-build counter."""
        return self.metrics.snapshot()
