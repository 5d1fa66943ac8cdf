"""JoinPlanner — cost-based operating-point selection per submitted batch
(port of ``repro.plan.planner``).

Given an ``LshEstimator`` (selectivity / band occupancy per (θ, batch))
and a ``CostTable`` (calibrated per-unit costs per (method, quant)), the
planner scores candidate operating points and emits a ``JoinPlan``:
method, quant mode, wave size snapped to the serve bucket ladder, the
initial ``RerankCap`` and merge-cap seeds and a hybrid-guard patience
hint.

Cost model (first-order, the reference's):

* NLJ work is exact — ``sec_per_dist × n_queries × N``.
* Traversal methods are per-query — ``sec_per_query × n_queries`` at
  the calibrated band, plus a correction when the predicted p90 band
  occupancy exceeds the calibrated batch's re-rank rate (extra band
  rows priced at the entry's per-distance cost).
* With no calibrated candidate, a selectivity heuristic decides: small
  tables and dense joins (selectivity ≥ ``NLJ_SELECTIVITY``) go
  brute-force, everything else takes the caller's default traversal
  method.

Plans are cached per (θ, method, quant, wave bucket, shards, pool_cap),
so repeated batches of one profile reuse the plan. Every number a plan
carries is a *seed*: caps stay overflow-checked and retried by the wave
drivers, so a bad estimate costs retry time, never pairs. A sharded
engine plans with its shard count: the estimate's per-shard occupancy
seeds the merge cap, and the mesh hint mirrors ``MeshPlan``'s rule.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.types import QUANT_FILTER_MODES
from repro_torch.plan.cost import CostEntry, CostTable
from repro_torch.plan.estimator import BandEstimate, LshEstimator


class PlanError(ValueError):
    """No admissible operating point for the request."""


@dataclasses.dataclass(frozen=True)
class JoinPlan:
    """One batch's planned operating point (all values advisory)."""
    method: str
    quant: str
    theta: float
    wave_size: int                 # snapped to the bucket ladder
    rerank_cap: int | None         # RerankCap seed (None: no cascade)
    merge_cap: int                 # sharded merge StickyCap seed
    hybrid_patience: int | None    # BBFS plateau hint (None: keep config)
    mesh_kind: str | None          # "vector" | "hybrid" MeshPlan hint
    predicted_seconds: float | None
    predicted_join_size: float | None
    source: str                    # "cost" | "heuristic" | "pinned"


class JoinPlanner:
    """Sticky, estimator-backed plan cache for one engine/data table."""

    # heuristic fallback thresholds (no calibrated candidate yet)
    NLJ_SELECTIVITY = 0.02     # predicted join density favoring NLJ
    NLJ_SMALL_N = 4096         # tables this small never pay indexing
    OOD_PATIENCE_FRAC = 0.25   # OOD query share that buys BBFS patience

    def __init__(self, estimator: LshEstimator, costs: CostTable, *,
                 buckets: tuple[int, ...] = (64, 128, 256),
                 metrics=None):
        self.estimator = estimator
        self.costs = costs
        self.buckets = tuple(buckets)
        self.metrics = metrics
        self._plans: dict[tuple, JoinPlan] = {}

    # -- wave bucket ladder -------------------------------------------------

    def snap_wave(self, n: int) -> int:
        """Ladder bucket minimizing total padded lanes ``⌈n/b⌉·b`` (ties
        go to the largest bucket — fewer dispatches at equal padding)."""
        return min(self.buckets, key=lambda b: (-(-n // b) * b, -b))

    # -- cost model ---------------------------------------------------------

    def score(self, entry: CostEntry, n_queries: int,
              est: BandEstimate | None = None) -> float:
        """Predicted wall-clock of ``n_queries`` under ``entry``."""
        if entry.method == "nlj":
            n_data = (est.n_data if est is not None
                      else self.estimator.n_data)
            return entry.sec_per_dist * n_queries * n_data
        sec = entry.sec_per_query * n_queries
        if est is not None and entry.n_rerank > 0:
            extra = (est.occ_quantiles.get(0.9, 0.0)
                     - entry.rerank_per_query) * n_queries
            if extra > 0:
                sec += extra * entry.sec_per_dist
        return sec

    def choose(self, n_queries: int, *, methods, quants,
               est: BandEstimate | None = None
               ) -> tuple[str, str, float] | None:
        """Cheapest calibrated (method, quant) among the candidates, or
        None when nothing is calibrated yet. Estimator-free when ``est``
        is None — the serving admission path uses it that way, so
        planning a request never touches the device."""
        best = None
        for m in methods:
            for q in quants:
                e = self.costs.get(m, q)
                if e is None:
                    continue
                s = self.score(e, n_queries, est)
                if best is None or s < best[2]:
                    best = (m, q, s)
        return best

    # -- full batch planning ------------------------------------------------

    def plan(self, X, *, theta: float, pool_cap: int,
             method: str | None = None, quant: str | None = None,
             methods: tuple[str, ...] = ("nlj",),
             quants: tuple[str, ...] = ("off",),
             default_method: str | None = None,
             default_quant: str = "off",
             n_shards: int = 1, dim: int | None = None,
             merge_limit: int | None = None) -> JoinPlan:
        """Plan one batch. ``method``/``quant`` pin that knob; otherwise
        the planner picks from ``methods``/``quants`` by calibrated cost
        (falling back to the selectivity heuristic). Sticky per
        (θ, pins, wave bucket, shards, pool_cap)."""
        if isinstance(X, torch.Tensor):
            X = X.detach().cpu().numpy()
        X = np.asarray(X, np.float32)
        nb = int(X.shape[0])
        wave = self.snap_wave(nb)
        key = (round(float(theta), 6), method, quant, wave,
               int(n_shards), int(pool_cap))
        cached = self._plans.get(key)
        if cached is not None:
            self._count("plan.cache_hit")
            return cached
        self._count("plan.cache_miss")

        est = self.estimator.estimate(X, theta, n_shards=n_shards)
        cand_m = (method,) if method else tuple(methods)
        cand_q = (quant,) if quant else tuple(quants)
        choice = self.choose(nb, methods=cand_m, quants=cand_q, est=est)
        if choice is not None:
            m, q, secs = choice
            source = "pinned" if (method and quant) else "cost"
        else:
            m = method or self._heuristic_method(est, default_method)
            q = quant or default_quant
            secs = None
            source = "pinned" if (method and quant) else "heuristic"

        rcap = (est.rerank_cap(int(pool_cap))
                if q in QUANT_FILTER_MODES else None)
        limit = int(merge_limit if merge_limit is not None
                    else (est.n_data if m == "nlj" else pool_cap))
        plan = JoinPlan(
            method=m, quant=q, theta=float(theta), wave_size=wave,
            rerank_cap=rcap,
            merge_cap=est.merge_cap(limit, exact=(m == "nlj")),
            hybrid_patience=self._patience_hint(m, est),
            mesh_kind=self._mesh_hint(m, est, n_shards, dim),
            predicted_seconds=secs, predicted_join_size=est.join_size,
            source=source)
        self._plans[key] = plan
        if self.metrics is not None:
            self.metrics.gauge(
                "plan.predicted_join_size",
                help="planner: predicted |X join Y| of the last planned "
                     "batch").set(est.join_size)
            self.metrics.gauge(
                "plan.merge_cap_estimate",
                help="planner: sharded merge StickyCap seed of the last "
                     "planned batch").set(plan.merge_cap)
        return plan

    # -- pieces -------------------------------------------------------------

    def _heuristic_method(self, est: BandEstimate,
                          default_method: str | None) -> str:
        if (est.n_data <= self.NLJ_SMALL_N
                or est.selectivity >= self.NLJ_SELECTIVITY
                or default_method is None):
            return "nlj"
        return default_method

    def _patience_hint(self, method: str,
                       est: BandEstimate) -> int | None:
        """Recall insurance for adaptive BBFS: an OOD-heavy batch whose
        escalated pairs are mostly band gets one extra plateau iteration
        (advisory)."""
        if (method == "es_mi_adapt"
                and est.ood_frac >= self.OOD_PATIENCE_FRAC
                and est.esc_band >= 0.5):
            return 2
        return None

    @staticmethod
    def _mesh_hint(method: str, est: BandEstimate, n_shards: int,
                   dim: int | None) -> str | None:
        """Informational mirror of ``MeshPlan``'s rule (rows a shard below
        the hybrid floor with ≥ 2 whole slabs → dimension+vector hybrid);
        the engine's ``_mesh_plan``, which also knows the devices,
        decides."""
        if n_shards <= 1:
            return None
        if method != "nlj":
            return "vector"          # traversal keeps whole vectors
        from repro_torch.core.distributed import HYBRID_ROW_FLOOR
        from repro_torch.quant.pdx import DEFAULT_SLAB
        rows = -(-est.n_data // max(n_shards, 1))
        if rows < HYBRID_ROW_FLOOR and dim and dim >= 2 * DEFAULT_SLAB:
            return "hybrid"
        return "vector"

    def _count(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.counter(
                name, help="planner sticky-plan cache traffic").inc()
