"""The search-path joins of the PyTorch port against the JAX package.

``index``, ``es``, ``es_hws`` and ``es_sws`` run a greedy search over the
data index G_Y, then a BFS range expansion; the caching methods run in
MST wavefronts over the query index G_X and seed each query from its
parent's cache entry. Both packages traverse the *same* graphs: the
JAX-built ``index_y``/``index_x`` fixtures are carried into the port with
``graph_index_from_numpy`` and installed with ``adopt``. On them the
port's pairs, ``n_dist``, ``n_iters`` and cache counters must equal the
JAX engine's, with the wave pipeline's overlap on and off; under sq8 also
``n_rerank`` and ``overflow_retries``, against the reference run with
overlap off (with overlap on the reference checks a wave's band against
the sticky cap as grown by an earlier wave's retry; see
``test_torch_sq8.py``).

θ is taken from ``thresholds()`` and moved to the middle of its gap when a
pair lies within 1e-6 (relative) of θ² in float64 (``_clear_theta``), so
f32 rounding cannot decide a pair differently in the two packages.
"""
import re

import numpy as np
import pytest
import torch

from repro.core import JoinConfig as JJoinConfig
from repro.core import TraversalConfig as JTraversalConfig
from repro.data.vectors import thresholds
from repro.engine import JoinEngine as JJoinEngine
from repro.launch import join as jlaunch
from repro_torch.core import JoinConfig, TraversalConfig, exact_join_pairs
from repro_torch.core.types import graph_index_from_numpy, pair_keys
from repro_torch.engine import JoinEngine
from repro_torch.launch import join as launch

CPU = torch.device("cpu")
WAVE = 48          # several waves, the last one padded
CAP = 8            # re-rank cap small enough that bands overflow
SEARCH = ("index", "es", "es_hws", "es_sws")
CACHE_FIELDS = ("cache_hits", "cache_misses", "cache_evictions",
                "peak_cache_entries")


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


def _port_index(jidx):
    return graph_index_from_numpy(
        np.asarray(jidx.vecs), np.asarray(jidx.nbrs), np.asarray(jidx.start),
        np.asarray(jidx.mean_nbr_dist), jidx.n_data, CPU)


@pytest.fixture(scope="module")
def theta(ds_manifold):
    return _clear_theta(ds_manifold, float(thresholds(ds_manifold, 3)[1]))


@pytest.fixture(scope="module")
def port_indexes(index_y, index_x):
    return _port_index(index_y), _port_index(index_x)


def _jcfg(method, theta, quant="off", overlap=True):
    return JJoinConfig(method=method, theta=theta, wave_size=WAVE,
                       quant=quant, overlap=overlap,
                       traversal=JTraversalConfig(rerank_cap=CAP))


def _cfg(method, theta, quant="off", overlap=True):
    return JoinConfig(method=method, theta=theta, wave_size=WAVE,
                      quant=quant, overlap=overlap,
                      traversal=TraversalConfig(rerank_cap=CAP))


@pytest.fixture(scope="module")
def jax_results(ds_manifold, index_y, index_x, theta):
    """The reference's joins: quant off with overlap on; sq8 with overlap
    off."""
    out = {}
    for quant, methods, overlap in [("off", SEARCH, True),
                                    ("sq8", ("es_hws", "es_sws"), False)]:
        for m in methods:
            eng = JJoinEngine(ds_manifold.Y,
                              default=_jcfg(m, theta, quant, overlap))
            out[m, quant] = eng.join(ds_manifold.X, index_y=index_y,
                                     index_x=index_x)
    return out


def _port_join(ds, port_indexes, cfg):
    iy, ix = port_indexes
    eng = JoinEngine(ds.Y, default=cfg, device=CPU)
    return eng, eng.join(ds.X, index_y=iy, index_x=ix)


def _assert_same(got, want, n, fields):
    np.testing.assert_array_equal(pair_keys(got.pairs, n),
                                  pair_keys(want.pairs, n))
    assert got.pairs.dtype == np.int64
    for f in fields:
        assert getattr(got.stats, f) == getattr(want.stats, f), f


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("method", SEARCH)
def test_search_join_identical_to_jax(ds_manifold, port_indexes, theta,
                                      jax_results, method, overlap):
    eng, got = _port_join(ds_manifold, port_indexes,
                          _cfg(method, theta, overlap=overlap))
    assert eng.n_index_builds == 0                  # the adopted graphs
    _assert_same(got, jax_results[method, "off"], ds_manifold.Y.shape[0],
                 ("n_dist", "n_iters", "n_overflow") + CACHE_FIELDS)
    if method in ("es_hws", "es_sws"):
        assert got.stats.cache_hits > 0             # parents seeded lanes
    else:
        assert got.stats.cache_hits == got.stats.peak_cache_entries == 0


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("method", ["es_hws", "es_sws"])
def test_sq8_search_join_identical_to_jax(ds_manifold, port_indexes, theta,
                                          jax_results, method, overlap):
    eng, got = _port_join(ds_manifold, port_indexes,
                          _cfg(method, theta, "sq8", overlap))
    assert eng.build_counts == {"index_y": 0, "index_x": 0, "merged": 0,
                                "sharded": 0, "quant": 1, "sketch": 0,
                                "pdx": 0}
    fields = ("n_dist", "n_iters", "n_rerank", "n_overflow",
              "quant_bytes") + CACHE_FIELDS
    if not overlap:
        fields += ("overflow_retries", "n_rerank_gather")
    want = jax_results[method, "sq8"]
    _assert_same(got, want, ds_manifold.Y.shape[0], fields)
    assert got.stats.n_rerank > 0
    assert got.stats.overflow_retries >= want.stats.overflow_retries > 0


def test_build_counts_per_method(ds_manifold):
    """es / es_hws / es_sws share one G_Y; only the caching methods build
    G_X, once per query set; the MI methods build the merged index."""
    Y, X = ds_manifold.Y[:600], ds_manifold.X[:40]
    theta = float(thresholds(ds_manifold, 3)[1])
    eng = JoinEngine(Y, build_kw=dict(k=16, degree=8), device=CPU)
    for m in ("index", "es"):
        eng.join(X, JoinConfig(method=m, theta=theta))
    assert eng.build_counts == {"index_y": 1, "index_x": 0, "merged": 0,
                                "sharded": 0, "quant": 0, "sketch": 0,
                                "pdx": 0}
    for m in ("es_hws", "es_sws", "es_hws"):
        eng.join(X, JoinConfig(method=m, theta=theta))
    assert (eng.build_counts["index_y"], eng.build_counts["index_x"]) == (1, 1)
    eng.join(X[:20], JoinConfig(method="es_sws", theta=theta))
    assert eng.build_counts["index_x"] == 2         # another query set
    eng.join(X, JoinConfig(method="es_mi", theta=theta))
    assert eng.build_counts == {"index_y": 1, "index_x": 2, "merged": 1,
                                "sharded": 0, "quant": 0, "sketch": 0,
                                "pdx": 0}


def test_sweep_builds_one_index(ds_manifold):
    """A sweep over three θ on the search path builds G_Y and G_X once;
    every result is sound and a larger θ finds at least as many pairs."""
    Y, X = ds_manifold.Y[:600], ds_manifold.X[:40]
    eng = JoinEngine(Y, build_kw=dict(k=16, degree=8), device=CPU)
    ths = [float(t) for t in thresholds(ds_manifold, 3)]
    rs = eng.sweep(X, ths, JoinConfig(method="es_sws", wave_size=16))
    assert (eng.build_counts["index_y"], eng.build_counts["index_x"]) == (1, 1)
    sizes = [len(r.pairs) for r in rs]
    assert sizes == sorted(sizes) and sizes[-1] > 0
    for theta, r in zip(ths, rs):
        truth = pair_keys(exact_join_pairs(X, eng.Y, theta), 600)
        assert np.setdiff1d(pair_keys(r.pairs, 600), truth).size == 0


def _launch_line(out: str) -> str:
    line = next(ln for ln in out.splitlines() if " pairs in " in ln)
    return re.sub(r" in [0-9.]+s", "", line)


@pytest.mark.parametrize("method", ["index", "es_sws"])
def test_launcher_matches_jax(capsys, method):
    argv = ["--n-data", "1200", "--n-query", "64", "--dim", "16",
            "--engine-spec", "ci", "--theta-q", "3", "--method", method]
    assert launch.main(["--device", "cpu", *argv]) == 0
    got = capsys.readouterr().out
    assert jlaunch.main(argv) == 0
    want = capsys.readouterr().out
    assert _launch_line(got) == _launch_line(want)
    assert "sound=True" in got
