"""CostTable — calibrated per-unit costs for the JoinPlanner (a copy of
``repro.plan.cost``).

Every completed join already reports a field-complete ``JoinStats``
(wall-clock split by phase, distance / re-rank / byte meters). The cost
table turns those meters into per-unit costs per ``(method, quant)``
operating point — seconds per query for the traversal methods, seconds
per distance for the brute-force NLJ — which is all the planner's cost
model needs to rank candidate plans (``plan.planner``).

Calibration is *observational*: the engine feeds every finished batch
through ``observe`` and the table keeps, per key, the **fastest**
per-query measurement seen (warmup batches carry jit compile time; the
first post-compile batch wins and the entry then sticks, so repeated
bench runs and long-lived serving tenants share one steady-state
measurement instead of re-measuring — the table lives on the engine).

Stdlib-only on purpose: the engine imports this at module load.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class CostEntry:
    """Per-unit costs of one calibrated ``(method, quant)`` point."""
    method: str
    quant: str
    n_queries: int            # batch size of the calibrating join
    seconds: float            # its wall-clock (JoinStats.total_seconds)
    n_dist: int               # filter-tier distance evaluations
    n_rerank: int             # exact f32 re-rank evaluations
    bytes_assembly: int       # bulky per-wave transfer bytes

    @property
    def sec_per_query(self) -> float:
        return self.seconds / max(self.n_queries, 1)

    @property
    def sec_per_dist(self) -> float:
        return self.seconds / max(self.n_dist, 1)

    @property
    def rerank_per_query(self) -> float:
        return self.n_rerank / max(self.n_queries, 1)

    def as_dict(self) -> dict[str, Any]:
        return dict(dataclasses.asdict(self),
                    sec_per_query=self.sec_per_query,
                    sec_per_dist=self.sec_per_dist)


class CostTable:
    """Fastest-observation-wins calibration table keyed (method, quant)."""

    def __init__(self):
        self._entries: dict[tuple[str, str], CostEntry] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def observe(self, method: str, quant: str, n_queries: int,
                stats) -> bool:
        """Offer one finished join as a calibration point. Returns True
        if it (re)placed the entry — i.e. it is the fastest per-query
        measurement for its key so far."""
        if n_queries <= 0:
            return False
        secs = float(stats.total_seconds)
        if secs <= 0.0:
            return False
        cur = self._entries.get((method, quant))
        if cur is not None and cur.sec_per_query <= secs / n_queries:
            return False
        self._entries[(method, quant)] = CostEntry(
            method=method, quant=quant, n_queries=int(n_queries),
            seconds=secs, n_dist=int(stats.n_dist),
            n_rerank=int(stats.n_rerank),
            bytes_assembly=int(stats.bytes_assembly))
        return True

    def get(self, method: str, quant: str) -> CostEntry | None:
        return self._entries.get((method, quant))

    def entries(self) -> list[CostEntry]:
        return list(self._entries.values())

    def snapshot(self) -> dict[str, dict[str, Any]]:
        """JSON-able ``{"method/quant": {per-unit costs…}}`` export."""
        return {f"{m}/{q}": e.as_dict()
                for (m, q), e in sorted(self._entries.items())}
