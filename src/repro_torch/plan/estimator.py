"""LshEstimator — join-size / band-occupancy estimation over the sketch tier
(port of ``repro.plan.estimator``).

The sketch tier's SimHash bits double as a per-dataset LSH sample: a
cached sketch over ≤ ``SAMPLE_Y`` data rows plus ``SAMPLE_Q`` sampled
queries per batch give, for any (θ, X-batch), a certified *superset* of
the true in-range mask (``quant.sketch.sketch_survivors``, which runs the
Hamming kernel on the data's device). Scaled survivor counts therefore
bound per-query band occupancy from above, and exact f32 distances on the
same raw sample rows (a 64 × 2048 × d numpy product on the host, as in
the reference) give the join-size point estimate and the per-tier
escalation split.

The sample draws, sample sizes, ``HEADROOM`` and the cap arithmetic are
the reference's, so the engine's sticky caps equal the reference's. Only
the sampled rows leave the device: the data table is indexed by the
sampled ids where it lives.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.quant import sketch as SK

# Merge-cap floor: the sharded drivers' cold-start merge capacity, so a
# seeded cap is never below what an unseeded run would start with.
MERGE_CAP_FLOOR = 32


@dataclasses.dataclass(frozen=True)
class BandEstimate:
    """Everything the planner wants to know about one (θ, X-batch).

    Occupancy numbers are *scaled to the full table* (sample count ×
    N / sample size); ``occ_max`` carries the certified-superset
    property, the quantiles are point estimates. The fields are the
    reference's (see ``repro.plan.estimator.BandEstimate``).
    """
    theta: float
    n_queries: int
    n_data: int
    n_sample_q: int
    n_sample_y: int
    scale: float
    occ_max: float
    occ_quantiles: dict[float, float]
    join_size: float
    esc_sketch: float
    esc_band: float
    ood_frac: float
    shard_occ: tuple[float, ...]       # per shard: scaled max per-(query,
    #                                    shard) band occupancy over the
    #                                    sharded drivers' contiguous shards
    shard_true_occ: tuple[float, ...]  # the same from exact in-range counts
    #                                    (what the mesh NLJ's pool holds)

    HEADROOM = 1.25

    @property
    def selectivity(self) -> float:
        denom = self.n_queries * self.n_data
        return self.join_size / denom if denom > 0 else 0.0

    @property
    def shard_imbalance(self) -> float:
        """Max over mean of the non-empty shards' band occupancy."""
        occ = [s for s in self.shard_occ if s > 0]
        if not occ:
            return 1.0
        mean = sum(occ) / len(occ)
        return max(occ) / mean if mean > 0 else 1.0

    def rerank_cap(self, pool_cap: int) -> int:
        """Power-of-two band capacity covering the predicted max
        occupancy with headroom."""
        est = self.occ_max * self.HEADROOM
        return int(min(ops.next_pow2(max(int(np.ceil(est)), 16)),
                       pool_cap))

    def merge_cap(self, limit: int, *, floor: int = MERGE_CAP_FLOOR,
                  exact: bool = False) -> int:
        """Power-of-two merged-pool capacity covering the predicted worst
        per-shard occupancy with headroom, at most ``limit`` (the plan's
        advisory seed). ``exact`` sizes it from the sampled true in-range
        counts instead of the sketch-band superset."""
        if exact:
            occ = (max(self.shard_true_occ) if self.shard_true_occ
                   else 0.0)
        else:
            occ = max(self.shard_occ) if self.shard_occ else self.occ_max
        need = max(int(np.ceil(occ * self.HEADROOM)), floor)
        return int(min(ops.next_pow2(need), max(limit, 1)))


class LshEstimator:
    """Cached LSH sample over one data table; per-batch estimates.

    Sampling is the reference's: one ``default_rng(SEED)`` stream per
    call, the ≤ ``SAMPLE_Y``-row data draw consuming the stream only on
    the first call, and ``rng.choice(nb, SAMPLE_Q, replace=nb <
    SAMPLE_Q)`` for queries. ``Y`` is the data tensor; the sample's
    sketch lives on its device.
    """

    SAMPLE_Q = 64
    SAMPLE_Y = 2048
    SEED = 0xC0FFEE
    QUANTILES = (0.5, 0.9, 0.99)

    def __init__(self, Y: torch.Tensor, *, sample_y: int | None = None):
        self._Y = Y                      # sampled lazily
        self.sample_y = sample_y or self.SAMPLE_Y
        self._store: SK.SketchStore | None = None
        self._rows: np.ndarray | None = None   # raw sampled data rows
        self._y_idx: np.ndarray | None = None
        self._scale = 1.0
        self.n_data = int(Y.shape[0])

    def _ensure_sample(self, rng) -> None:
        if self._store is not None:
            return
        N = self.n_data
        y_idx = (np.arange(N) if N <= self.sample_y
                 else rng.choice(N, self.sample_y, replace=False))
        rows = self._Y[torch.as_tensor(y_idx, device=self._Y.device)]
        self._store = SK.build_sketch(rows)
        self._rows = rows.float().cpu().numpy()
        self._y_idx = np.asarray(y_idx)
        self._scale = N / len(y_idx)

    def estimate(self, X_batch, theta: float, *,
                 n_shards: int = 1) -> BandEstimate:
        """One (θ, X-batch) estimate: a query encode + Hamming/bound pass
        on the cached sample plus an exact numpy distance block on the
        raw rows; the occupancies also per shard of ``n_shards``."""
        if isinstance(X_batch, torch.Tensor):
            X_batch = X_batch.detach().cpu().numpy()
        X = np.asarray(X_batch, np.float32)
        nb = int(X.shape[0])
        theta = float(theta)
        rng = np.random.default_rng(self.SEED)
        self._ensure_sample(rng)
        q_idx = rng.choice(nb, self.SAMPLE_Q, replace=nb < self.SAMPLE_Q)
        Xs = X[q_idx]

        surv = SK.sketch_survivors(Xs, self._store, theta)   # (Sq, Sy)
        counts = surv.sum(axis=1)                            # per query
        occ_max = float(counts.max()) * self._scale
        occ_q = {q: float(np.quantile(counts, q)) * self._scale
                 for q in self.QUANTILES}

        # exact distances on the raw sample rows (host numpy, as in the
        # reference): the join-size point estimate and the escalation split
        rows = self._rows
        d2 = (np.sum(Xs * Xs, axis=1)[:, None]
              + np.sum(rows * rows, axis=1)[None, :]
              - 2.0 * (Xs @ rows.T))
        true = d2 <= np.float32(theta) ** 2                  # (Sq, Sy)
        true_counts = true.sum(axis=1)
        join_size = float(true_counts.mean()) * self._scale * nb

        n_pairs = counts.size * surv.shape[1]
        n_surv = int(counts.sum())
        esc_sketch = n_surv / max(n_pairs, 1)
        esc_band = (max(0, n_surv - int(true_counts.sum()))
                    / max(n_surv, 1))
        ood_frac = float((true_counts == 0).mean())

        return BandEstimate(
            theta=theta, n_queries=nb, n_data=self.n_data,
            n_sample_q=int(Xs.shape[0]), n_sample_y=int(surv.shape[1]),
            scale=self._scale, occ_max=occ_max, occ_quantiles=occ_q,
            join_size=join_size, esc_sketch=esc_sketch,
            esc_band=esc_band, ood_frac=ood_frac,
            shard_occ=self._shard_occ(surv, n_shards),
            shard_true_occ=self._shard_occ(true, n_shards))

    def _shard_occ(self, surv: np.ndarray, n_shards: int
                   ) -> tuple[float, ...]:
        """Scaled max per-(query, shard) survivor count, the sampled rows
        mapped to the contiguous row shards of the sharded drivers (⌈N/S⌉
        rows a shard), each scaled by its true rows over its samples."""
        S = max(int(n_shards), 1)
        if S == 1:
            return (float(surv.sum(axis=1).max()) * self._scale,)
        rows_per = -(-self.n_data // S)
        shard_of = self._y_idx // rows_per
        occ = []
        for s in range(S):
            cols = shard_of == s
            n_cols = int(cols.sum())
            if n_cols == 0:
                occ.append(0.0)
                continue
            true_rows = min(rows_per, self.n_data - s * rows_per)
            per_q = surv[:, cols].sum(axis=1)
            occ.append(float(per_q.max()) * (true_rows / n_cols))
        return tuple(occ)
