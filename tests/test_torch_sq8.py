"""The sq8 join paths of the PyTorch port against the JAX package.

The merged-index join under ``quant="sq8"`` traverses on certified int8
lower bounds and re-ranks the ambiguous band of each pool exactly. On the
reference's merged index (carried into the port unchanged), ``es_mi`` and
``es_mi_adapt`` must give the JAX engine's pairs, ``n_dist``, ``n_iters``,
``n_rerank`` and ``n_ood`` with overlap on and off, and its
``overflow_retries`` with overlap off, with a small re-rank cap so that
band overflows and retries happen.

The reference is the JAX engine with overlap off. With overlap on, the
reference checks a wave's band occupancy against the sticky cap as grown
by an earlier wave's retry, not against the cap the wave's epilogue ran
at, and drops the band entries ranked between the two (on the manifold
case below it loses 9 of 1499 pairs). The port checks against the wave's
own cap, so its pairs do not depend on the cap or on overlap; it then
counts one retry more than the reference where the reference dropped.
The sq8 NLJ must give the f32 NLJ's pairs; the reference's golden
equivalence (``tests/test_quant_modes.py``) is mirrored for ``nlj`` and
``es_mi``; a re-rank cap of 1 must retry without changing the pairs; and
the launcher must print the reference launcher's pair count and
``n_dist``.

θ is taken from ``thresholds()`` and moved to the middle of its gap when
a pair lies within 1e-6 (relative) of θ² in float64 (``_clear_theta``),
so f32 rounding cannot decide a pair differently in the two packages.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

from repro.core import JoinConfig as JJoinConfig
from repro.core import TraversalConfig as JTraversalConfig
from repro.core import build_merged_index as jbuild_merged
from repro.core import exact_join_pairs as jexact
from repro.data.vectors import make_dataset, thresholds
from repro.engine import JoinEngine as JJoinEngine
from repro.launch import join as jlaunch
from repro_torch.configs.vectorjoin import EngineSpec, make_engine
from repro_torch.core import JoinConfig, TraversalConfig, exact_join_pairs
from repro_torch.core.join import cascade_join_pairs
from repro_torch.core.types import graph_index_from_numpy, pair_keys
from repro_torch.engine import JoinEngine
from repro_torch.launch import join as launch
from repro_torch.quant import build_cascade

CPU = torch.device("cpu")
WAVE = 48          # several waves, the last one padded
CAP = 8            # re-rank cap small enough that bands overflow


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
def cases(ds_manifold, index_merged, ds_ood):
    ood_merged = jbuild_merged(ds_ood.Y, ds_ood.X, k=32, degree=16)
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


def _cfg(method, theta, overlap=True, cap=CAP):
    return JoinConfig(method=method, theta=theta, wave_size=WAVE,
                      quant="sq8", overlap=overlap,
                      traversal=TraversalConfig(rerank_cap=cap))


@pytest.fixture(scope="module")
def jax_results(cases):
    """The reference's sq8 join per (dataset, method), overlap off."""
    out = {}
    for name, (ds, jidx, theta) in cases.items():
        for method in ("es_mi", "es_mi_adapt"):
            cfg = JJoinConfig(method=method, theta=theta, wave_size=WAVE,
                              quant="sq8", overlap=False,
                              traversal=JTraversalConfig(rerank_cap=CAP))
            out[name, method] = JJoinEngine(ds.Y, default=cfg).join(
                ds.X, index_merged=jidx)
    return out


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("method", ["es_mi", "es_mi_adapt"])
@pytest.mark.parametrize("name", ["manifold", "ood"])
def test_sq8_mi_join_identical_to_jax(cases, jax_results, name, method,
                                      overlap):
    ds, jidx, theta = cases[name]
    want = jax_results[name, method]
    eng = JoinEngine(ds.Y, default=_cfg(method, theta, overlap), device=CPU)
    got = eng.join(ds.X, index_merged=_port_index(jidx))
    assert eng.build_counts == {"index_y": 0, "index_x": 0, "merged": 0,
                                "sharded": 0, "quant": 1, "sketch": 0,
                                "pdx": 0}
    n = ds.Y.shape[0]
    np.testing.assert_array_equal(pair_keys(got.pairs, n),
                                  pair_keys(want.pairs, n))
    fields = ["n_dist", "n_iters", "n_rerank", "n_ood", "n_overflow",
              "quant_bytes"]
    if not overlap:
        fields += ["overflow_retries", "n_rerank_gather"]
    for f in fields:
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    assert got.stats.n_rerank > 0
    assert got.stats.overflow_retries >= want.stats.overflow_retries > 0
    if name == "ood" and method == "es_mi_adapt":
        assert got.stats.n_ood > 0                      # hybrid BBFS ran


@pytest.mark.parametrize("name", ["manifold", "ood"])
def test_sq8_nlj_equals_the_f32_truth(cases, name):
    ds, _, theta = cases[name]
    Y = torch.from_numpy(ds.Y)
    truth = exact_join_pairs(ds.X, Y, theta)
    got, counts = cascade_join_pairs(ds.X, Y, theta, build_cascade(Y, "sq8"))
    n = ds.Y.shape[0]
    np.testing.assert_array_equal(pair_keys(got, n), pair_keys(truth, n))
    np.testing.assert_array_equal(pair_keys(truth, n),
                                  pair_keys(jexact(ds.X, ds.Y, theta), n))
    assert 0 < counts["n_rerank"] < ds.X.shape[0] * n
    res = JoinEngine(ds.Y, device=CPU).join(ds.X, method="nlj", theta=theta,
                                            cfg=_cfg("nlj", theta))
    np.testing.assert_array_equal(pair_keys(res.pairs, n),
                                  pair_keys(truth, n))
    assert res.stats.n_rerank == counts["n_rerank"]


def test_rerank_cap_one_retries_with_the_same_pairs(cases):
    ds, jidx, theta = cases["manifold"]
    idx = _port_index(jidx)
    base = JoinEngine(ds.Y, device=CPU).join(
        ds.X, _cfg("es_mi", theta, cap=1024), index_merged=idx)
    one = JoinEngine(ds.Y, device=CPU).join(
        ds.X, _cfg("es_mi", theta, cap=1), index_merged=idx)
    assert base.stats.overflow_retries == 0
    assert one.stats.overflow_retries > 0
    assert one.pair_set() == base.pair_set()
    assert one.stats.n_rerank == base.stats.n_rerank


# -- golden equivalence (mirrors tests/test_quant_modes.py) ------------------

GOLDEN_TC = TraversalConfig(beam_width=64, expand_per_iter=4, pool_cap=1024,
                            hybrid_beam=64, seeds_max=8, max_iters=2048)


@pytest.fixture(scope="module")
def golden():
    ds = make_dataset("manifold", n_data=1500, n_query=96, dim=40, seed=42)
    theta = float(thresholds(ds, 3)[0])
    eng = JoinEngine(ds.Y, build_kw=dict(k=24, degree=12), device=CPU)
    truth = set(map(tuple, exact_join_pairs(ds.X, eng.Y, theta).tolist()))
    assert len(truth) > 0
    return ds, eng, theta, truth


@pytest.mark.parametrize("method", ["nlj", "es_mi"])
def test_golden_identical_pair_set(golden, method):
    """NLJ is exact by contract and es_mi reaches full recall at this
    budget on f32, so sq8 must emit the identical — and exact — set."""
    ds, eng, theta, truth = golden

    def cfg(quant):
        return JoinConfig(method=method, theta=theta, traversal=GOLDEN_TC,
                          wave_size=64, quant=quant)
    if method != "nlj":
        assert eng.join(ds.X, cfg("off")).pair_set() == truth, \
            "budget precondition"
    assert eng.join(ds.X, cfg("sq8")).pair_set() == truth


def test_sq8_engine_builds_through_the_cascade(ds_manifold):
    """``quant_build="sq8"``: the merged index comes from the cascade
    build (the f32 build's edges), and its int8 store is built once and
    shared with the joins served from it."""
    Y, X = ds_manifold.Y[:600], ds_manifold.X[:40]
    theta = float(thresholds(ds_manifold, 3)[1])
    eng = make_engine(Y, EngineSpec(k=16, degree=8, quant="sq8",
                                    quant_build="sq8"), device=CPU)
    assert eng.default.quant == "sq8"
    r1 = eng.join(X, theta=theta)
    r2 = eng.join(X, theta=theta * 1.1)
    assert eng.build_counts == {"index_y": 0, "index_x": 0, "merged": 1,
                                "sharded": 0, "quant": 1, "sketch": 0,
                                "pdx": 0}
    f32 = make_engine(Y, "default", k=16, degree=8, device=CPU)
    assert torch.equal(eng.merged_index(X).nbrs, f32.merged_index(X).nbrs)
    truth = exact_join_pairs(X, eng.Y, theta * 1.1)
    assert np.setdiff1d(pair_keys(r2.pairs, 600),
                        pair_keys(truth, 600)).size == 0      # sound
    assert r1.stats.quant_bytes > 0


def _launch_line(out: str) -> str:
    line = next(ln for ln in out.splitlines() if " pairs in " in ln)
    return re.sub(r" in [0-9.]+s", "", line)


def test_launcher_sq8_matches_jax(capsys):
    argv = ["--n-data", "1200", "--n-query", "64", "--dim", "16",
            "--engine-spec", "ci", "--theta-q", "3", "--quant", "sq8"]
    assert launch.main(["--device", "cpu", *argv]) == 0
    got = capsys.readouterr().out
    assert jlaunch.main(argv) == 0
    want = capsys.readouterr().out
    assert _launch_line(got) == _launch_line(want)
    assert "sound=True" in got and "rerank=" in got


def test_unported_quant_modes_raise(ds_manifold):
    """Every quant mode of the reference is ported; a mode that is not one
    of them is refused, by the config and by the index build."""
    for quant in ("int4", "sketch4", ""):
        with pytest.raises(ValueError, match="unknown quant mode"):
            dataclasses.replace(JoinConfig(), quant=quant)
        with pytest.raises(KeyError):
            build_cascade(ds_manifold.Y[:50], quant)
    eng = JoinEngine(ds_manifold.Y[:50], device=CPU)
    for quant in ("sketch8", "pdx8"):
        cfg = JoinConfig(method="nlj", theta=1.0, quant=quant)
        assert eng.join(ds_manifold.X[:4], cfg).pairs.shape[1] == 2
