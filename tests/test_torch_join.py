"""The merged-index join of the PyTorch port against the JAX package.

Both packages traverse the *same* graph: the JAX-built merged index is
carried into the port with ``graph_index_from_numpy``. On it, ``es_mi`` and
``es_mi_adapt`` must emit identical pair sets with identical ``n_dist``,
``n_iters`` and ``n_ood`` — with the wave pipeline's overlap on and off —
on the in-distribution and the OOD data. The exact NLJ must equal the
reference's, with pairs on the θ boundary judged in float64.

θ is taken from ``thresholds()``; a pair within 1e-6 (relative) of θ² in
float64 would let f32 rounding decide it differently in the two packages,
so ``_clear_theta`` moves θ to the middle of its gap when that happens.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import build_merged_index as jbuild_merged
from repro.core import exact_join_pairs as jexact
from repro.core import JoinConfig as JJoinConfig
from repro.core.ood import predict_ood as jpredict_ood
from repro.data.vectors import thresholds
from repro.engine import JoinEngine as JJoinEngine
from repro_torch.core import JoinConfig, exact_join_pairs, predict_ood
from repro_torch.core.types import graph_index_from_numpy, pair_keys
from repro_torch.engine import JoinEngine

CPU = torch.device("cpu")
WAVE = 48          # several waves, the last one padded


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the port's CPU tests run many small ops, and
    with the suite's parallel workers on every core, thread-pool regions
    waiting for descheduled threads slow them tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clear_theta(ds, theta: float) -> float:
    d2 = np.sort(((ds.X.astype(np.float64)[:, None, :]
                   - ds.Y.astype(np.float64)[None, :, :]) ** 2).sum(-1),
                 axis=None)
    t2 = theta ** 2
    i = np.searchsorted(d2, t2)
    lo, hi = d2[max(i - 1, 0)], d2[min(i, d2.size - 1)]
    if min(abs(t2 - lo), abs(hi - t2)) <= 1e-6 * t2:
        theta = float(np.sqrt(0.5 * (lo + hi)))   # middle of the gap
    return theta


@pytest.fixture(scope="module")
def ood_merged(ds_ood):
    return jbuild_merged(ds_ood.Y, ds_ood.X, k=32, degree=16)


@pytest.fixture(scope="module")
def cases(ds_manifold, index_merged, ds_ood, ood_merged):
    return {
        "manifold": (ds_manifold, index_merged,
                     _clear_theta(ds_manifold,
                                  float(thresholds(ds_manifold, 3)[1]))),
        "ood": (ds_ood, ood_merged,
                _clear_theta(ds_ood, float(thresholds(ds_ood, 3)[1]))),
    }


def _port_index(jidx):
    return graph_index_from_numpy(
        np.asarray(jidx.vecs), np.asarray(jidx.nbrs), np.asarray(jidx.start),
        np.asarray(jidx.mean_nbr_dist), jidx.n_data, CPU)


@pytest.fixture(scope="module")
def jax_results(cases):
    """The reference's join per (dataset, method), overlap on."""
    out = {}
    for name, (ds, jidx, theta) in cases.items():
        for method in ("es_mi", "es_mi_adapt"):
            cfg = JJoinConfig(method=method, theta=theta, wave_size=WAVE)
            res = JJoinEngine(ds.Y, default=cfg).join(ds.X,
                                                      index_merged=jidx)
            out[name, method] = res
    return out


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("method", ["es_mi", "es_mi_adapt"])
@pytest.mark.parametrize("name", ["manifold", "ood"])
def test_mi_join_identical_to_jax(cases, jax_results, name, method, overlap):
    ds, jidx, theta = cases[name]
    want = jax_results[name, method]
    cfg = JoinConfig(method=method, theta=theta, wave_size=WAVE,
                     overlap=overlap)
    eng = JoinEngine(ds.Y, default=cfg, device=CPU)
    got = eng.join(ds.X, index_merged=_port_index(jidx))
    assert eng.build_counts["merged"] == 0          # the adopted graph
    n = ds.Y.shape[0]
    np.testing.assert_array_equal(pair_keys(got.pairs, n),
                                  pair_keys(want.pairs, n))
    assert got.pairs.dtype == np.int64
    assert got.stats.n_dist == want.stats.n_dist
    assert got.stats.n_iters == want.stats.n_iters
    assert got.stats.n_ood == want.stats.n_ood
    assert got.stats.n_overflow == want.stats.n_overflow
    if name == "ood" and method == "es_mi_adapt":
        assert got.stats.n_ood > 0                   # hybrid BBFS ran


@pytest.mark.parametrize("name", ["manifold", "ood"])
def test_predict_ood_identical_to_jax(cases, name):
    ds, jidx, _ = cases[name]
    qids = jidx.n_data + np.arange(ds.X.shape[0], dtype=np.int32)
    want = np.asarray(jpredict_ood(jidx, ds.X, qids))
    got = predict_ood(_port_index(jidx), torch.from_numpy(ds.X),
                      torch.from_numpy(qids))
    np.testing.assert_array_equal(got.numpy(), want)


def _judge_boundary(ds, got, want, theta):
    """Pairs in one set only must sit on θ² within f32 rounding."""
    n = ds.Y.shape[0]
    g, w = pair_keys(got, n), pair_keys(want, n)
    diff = np.setxor1d(g, w)
    q, y = diff // n, diff % n
    d64 = ((ds.X[q].astype(np.float64) - ds.Y[y].astype(np.float64)) ** 2
           ).sum(1)
    assert np.all(np.abs(d64 - theta ** 2) <= 1e-5 * theta ** 2)


@pytest.mark.parametrize("name", ["manifold", "ood"])
def test_exact_join_matches_jax(cases, name):
    ds, _, theta = cases[name]
    got = exact_join_pairs(ds.X, torch.from_numpy(ds.Y), theta)
    want = jexact(ds.X, ds.Y, theta)
    assert got.dtype == np.int64 and got.shape[1] == 2
    _judge_boundary(ds, got, want, theta)
    # the engine's nlj method is the same ground truth
    res = JoinEngine(ds.Y, device=CPU).join(ds.X, method="nlj", theta=theta)
    np.testing.assert_array_equal(res.pairs, got)
    assert res.stats.n_dist == ds.X.shape[0] * ds.Y.shape[0]


def test_merged_index_cached_and_sweep(ds_manifold, theta_mid):
    eng = JoinEngine(ds_manifold.Y[:600], device=CPU,
                     build_kw=dict(k=16, degree=8))
    X = ds_manifold.X[:40]
    rs = eng.sweep(X, [theta_mid, theta_mid * 1.2])
    assert eng.build_counts["merged"] == 1          # one build, two joins
    assert len(rs[1].pairs) >= len(rs[0].pairs)
    truth = exact_join_pairs(X, eng.Y, theta_mid * 1.2)
    n = 600
    found = pair_keys(rs[1].pairs, n)
    assert np.setdiff1d(found, pair_keys(truth, n)).size == 0   # sound


@pytest.mark.parametrize("bad", [dict(method="es_sws"),
                                 dict(method="es_mi_adapt")])
def test_unported_paths_raise(ds_manifold, bad):
    """Streaming (``submit``): on the tiny engine a batch gives sound pairs
    under global query ids. Two shards on the one CPU device are refused
    with the clear error at the first join (a ``DeviceMesh`` can hold
    them; ``tests/test_torch_distributed.py``)."""
    Y, X = ds_manifold.Y[:50], ds_manifold.X[:8]
    eng = JoinEngine(Y, device=CPU, build_kw=dict(k=8, degree=4))
    theta = float(thresholds(ds_manifold, 3)[2])
    cfg = dataclasses.replace(JoinConfig(), theta=theta, **bad)
    eng.submit(X[:4], cfg)
    res = eng.submit(X[4:], cfg)
    assert eng.n_submitted == 8
    truth = exact_join_pairs(X, torch.from_numpy(Y), theta)
    got = pair_keys(res.pairs, 50)
    assert got.size and np.all(res.pairs[:, 0] >= 4)
    assert np.setdiff1d(got, pair_keys(truth, 50)).size == 0     # sound
    with pytest.raises(ValueError, match="device"):
        JoinEngine(Y, device=CPU, n_shards=2).join(X, cfg, method="nlj")


def test_configs_and_stats_mirror_jax():
    from repro.core import TraversalConfig as JTraversalConfig
    from repro.core.types import JoinStats as JJoinStats
    from repro_torch.core import JoinStats, TraversalConfig

    assert dataclasses.asdict(JoinConfig()) == dataclasses.asdict(JJoinConfig())
    assert (dataclasses.asdict(TraversalConfig())
            == dataclasses.asdict(JTraversalConfig()))
    assert ([f.name for f in dataclasses.fields(JoinStats)]
            == [f.name for f in dataclasses.fields(JJoinStats)])
    with pytest.raises(ValueError, match="unknown method"):
        JoinConfig(method="bogus")
    a = JoinStats(n_dist=3, peak_cache_entries=5, band_occ_per_shard=(1,))
    b = JoinStats(n_dist=4, peak_cache_entries=2, band_occ_per_shard=(2,))
    ja = JJoinStats(n_dist=3, peak_cache_entries=5, band_occ_per_shard=(1,))
    jb = JJoinStats(n_dist=4, peak_cache_entries=2, band_occ_per_shard=(2,))
    assert a.merge(b).as_dict() == ja.merge(jb).as_dict()
