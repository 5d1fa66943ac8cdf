"""The planner of the PyTorch port against the JAX package.

``JoinPlanner`` scores operating points from the LSH estimate and the
calibrated cost table and caches one ``JoinPlan`` per profile. Its
arithmetic is host Python over the estimate (equal to the reference's,
``tests/test_torch_stream.py``) and the cost table, so on tables fed
identical ``observe`` calls every ``JoinPlan`` field equals the
reference's (``predicted_seconds`` to 1e-12 relative): before calibration
(the selectivity heuristic, with the small-table floor lowered so that
its traversal branch and the OOD patience hint run), after it, pinned,
with a merge limit, at sizes on and between the wave buckets. Also: the
sticky cache and its counters, ``snap_wave``'s tie rule,
``BandEstimate.selectivity``/``merge_cap``, ``JoinEngine.plan_config``
(pins, the wave snap, the patience hint) and ``plan_request`` (never
samples the estimator) against the JAX engine's, the refusal of more than
one shard, planned pairs equal to hand-tuned pairs (nlj and es_sws, off
and sq8), and ``launch.join --plan auto`` printing the reference
launcher's plan line.
"""
import dataclasses
import re

import pytest
import torch

from repro.core.types import JoinConfig as JJoinConfig
from repro.core.types import JoinStats as JJoinStats
from repro.data.vectors import make_dataset, thresholds
from repro.engine import JoinEngine as JJoinEngine
from repro.launch import join as jlaunch
from repro.plan import CostTable as JCostTable
from repro.plan import JoinPlanner as JJoinPlanner
from repro.plan import LshEstimator as JLshEstimator
from repro_torch.core import JoinConfig
from repro_torch.core.types import JoinStats
from repro_torch.engine import JoinEngine
from repro_torch.launch import join as launch
from repro_torch.obs.metrics import Metrics
from repro_torch.plan import (MERGE_CAP_FLOOR, CostTable, JoinPlanner,
                              LshEstimator)

CPU = torch.device("cpu")
BK = dict(k=12, degree=8)
# (method, quant, n_queries, seconds, n_dist, n_rerank) fed to both tables
OBSERVED = (("nlj", "off", 96, 5.0, 96 * 600, 0),
            ("es_sws", "off", 96, 0.1, 5000, 0),
            ("es_sws", "sq8", 96, 0.08, 5200, 900),
            ("es_mi_adapt", "sq8", 64, 0.07, 3000, 2000))
CASES = {
    "heuristic": dict(),
    "heuristic-default": dict(default_method="es_mi_adapt",
                              default_quant="sq8"),
    "cost": dict(methods=("nlj", "es_sws", "es_mi_adapt"),
                 quants=("off", "sq8")),
    "cost-method-pin": dict(method="es_sws", quants=("off", "sq8")),
    "pinned": dict(method="es_mi_adapt", quant="sq8"),
    "merge-limit": dict(default_method="es_sws", merge_limit=8),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the port's CPU tests run many small ops, and
    with the suite's parallel workers on every core, thread-pool regions
    waiting for descheduled threads slow them tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ds():
    return make_dataset("manifold", n_data=600, n_query=200, dim=16, seed=3)


@pytest.fixture(scope="module")
def grid(ds):
    return [float(t) for t in thresholds(ds, 7)]


def _feed(table, stats_cls, rows=OBSERVED) -> None:
    for m, q, n, secs, n_dist, n_rerank in rows:
        table.observe(m, q, n, stats_cls(expand_seconds=secs, n_dist=n_dist,
                                         n_rerank=n_rerank))


def _planners(ds, calibrated: bool):
    jp = JJoinPlanner(JLshEstimator(ds.Y), JCostTable())
    pp = JoinPlanner(LshEstimator(torch.from_numpy(ds.Y)), CostTable(),
                     metrics=Metrics())
    for p, stats_cls in ((jp, JJoinStats), (pp, JoinStats)):
        p.NLJ_SMALL_N = 100       # 600 rows: let the heuristic choose
        if calibrated:
            _feed(p.costs, stats_cls)
    return jp, pp


def _same_plan(got, want) -> None:
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    gs, ws = g.pop("predicted_seconds"), w.pop("predicted_seconds")
    assert g == w
    assert (gs is None) == (ws is None)
    if gs is not None:
        assert gs == pytest.approx(ws, rel=1e-12)


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_matches_jax(ds, grid, case, calibrated):
    """Every field of every plan equal, at three θ (from OOD-heavy and
    sparse to dense) and four batch sizes (one query, just past a
    bucket, a full bucket, past the ladder top)."""
    jp, pp = _planners(ds, calibrated)
    sources = set()
    for theta in (grid[1], grid[4], grid[6]):
        for n in (1, 65, 128, 200):
            kw = dict(theta=theta, pool_cap=1024, **CASES[case])
            want = jp.plan(ds.X[:n], **kw)
            got = pp.plan(torch.from_numpy(ds.X[:n]), **kw)
            _same_plan(got, want)
            sources.add(got.source)
    # 65 and 128 snap to one bucket (128): the second is a cache hit
    assert (pp.metrics.value("plan.cache_miss"),
            pp.metrics.value("plan.cache_hit")) == (9, 3)
    if case == "pinned":
        assert sources == {"pinned"}
    elif calibrated and case.startswith("cost"):
        assert sources == {"cost"}
    elif not calibrated:
        assert sources == {"heuristic"}


def test_heuristic_branches_and_patience_hint(ds, grid):
    """On the OOD-heavy θ the heuristic takes the default traversal
    method and adaptive BBFS gets the patience hint; on the dense θ it
    goes brute force; the 600-row table alone sends it to the NLJ."""
    jp, pp = _planners(ds, calibrated=False)
    sparse = pp.plan(ds.X[:64], theta=grid[1], pool_cap=1024,
                     default_method="es_mi_adapt")
    assert (sparse.method, sparse.hybrid_patience) == ("es_mi_adapt", 2)
    dense = pp.plan(ds.X, theta=grid[6], pool_cap=1024,
                    default_method="es_mi_adapt")
    assert dense.method == "nlj" and dense.merge_cap >= MERGE_CAP_FLOOR
    small = JoinPlanner(LshEstimator(torch.from_numpy(ds.Y)), CostTable())
    assert small.plan(ds.X, theta=grid[1], pool_cap=1024,
                      default_method="es_sws").method == "nlj"


def test_sticky_cache(ds, grid):
    _, pp = _planners(ds, calibrated=True)
    p1 = pp.plan(ds.X, theta=grid[2], pool_cap=1024)
    assert pp.plan(ds.X, theta=grid[2], pool_cap=1024) is p1
    assert pp.plan(ds.X[:193], theta=grid[2], pool_cap=1024) is p1
    assert pp.plan(ds.X, theta=grid[2] * 1.1, pool_cap=1024) is not p1
    assert pp.plan(ds.X, theta=grid[2], pool_cap=512) is not p1
    assert (pp.metrics.value("plan.cache_hit"),
            pp.metrics.value("plan.cache_miss")) == (2, 3)
    assert pp.metrics.value("plan.predicted_join_size") > 0


def test_snap_wave_matches_jax(ds):
    jp, pp = _planners(ds, calibrated=False)
    for buckets in ((64, 128, 256), (16, 32), (48,), (10, 30, 70)):
        jp.buckets = pp.buckets = buckets
        assert [pp.snap_wave(n) for n in range(1, 700)] == \
            [jp.snap_wave(n) for n in range(1, 700)]
    pp.buckets = (64, 128, 256)
    assert pp.snap_wave(384) == 128 and pp.snap_wave(256) == 256


@pytest.mark.parametrize("theta_idx", [0, 1, 3, 6])
def test_band_estimate_selectivity_and_merge_cap_match_jax(ds, grid,
                                                           theta_idx):
    want = JLshEstimator(ds.Y).estimate(ds.X, grid[theta_idx])
    got = LshEstimator(torch.from_numpy(ds.Y)).estimate(ds.X,
                                                        grid[theta_idx])
    assert got.selectivity == want.selectivity
    for limit in (1, 8, 64, 1024, 600):
        for exact in (False, True):
            for floor in (MERGE_CAP_FLOOR, 4):
                assert got.merge_cap(limit, floor=floor, exact=exact) == \
                    want.merge_cap(limit, floor=floor, exact=exact)


def test_more_than_one_shard_is_refused(ds, grid):
    """More shards than devices are refused by the mesh plan; the
    estimator and the planner take a shard count (their per-shard
    numbers are held to the reference in test_torch_distributed.py)."""
    from repro_torch.core.distributed import MeshPlan
    est = LshEstimator(torch.from_numpy(ds.Y))
    assert len(est.estimate(ds.X, grid[2], n_shards=2).shard_occ) == 2
    planner = JoinPlanner(est, CostTable())
    assert planner.plan(ds.X, theta=grid[2], pool_cap=1024, n_shards=2,
                        method="nlj", dim=16).mesh_kind in ("vector",
                                                            "hybrid")
    with pytest.raises(ValueError, match="device"):
        MeshPlan.plan(len(ds.Y), 16, 2, devices=1)


def _engines(ds, calibrated: bool):
    jeng = JJoinEngine(ds.Y, build_kw=BK)
    peng = JoinEngine(ds.Y, build_kw=BK, device=CPU, metrics=Metrics())
    if calibrated:
        _feed(jeng.cost_table, JJoinStats)
        _feed(peng.cost_table, JoinStats)
    return jeng, peng


@pytest.mark.parametrize("calibrated", [False, True])
def test_plan_config_matches_jax(ds, grid, calibrated):
    """Pinned and unpinned configs, the wave snapped from 999, and (OOD
    θ, adaptive BBFS by default) the patience hint in the traversal."""
    jeng, peng = _engines(ds, calibrated)
    for eng in (jeng, peng):
        eng.planner.NLJ_SMALL_N = 100
    for theta in (grid[1], grid[5]):
        for method, quant, base in (
                ("es_sws", "off", "es_sws"), (None, None, "es_mi_adapt"),
                (None, "sq8", "es_sws"), ("nlj", None, "nlj")):
            kw = dict(method=base, theta=theta, wave_size=999)
            want = jeng.plan_config(ds.X, JJoinConfig(**kw), method=method,
                                    quant=quant)
            got = peng.plan_config(ds.X, JoinConfig(**kw), method=method,
                                   quant=quant)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.wave_size in peng.planner.buckets
            if method:
                assert got.method == method
    hinted = peng.plan_config(ds.X, JoinConfig(method="es_mi_adapt",
                                               theta=grid[1]))
    if not calibrated:
        assert hinted.method == "es_mi_adapt"
        assert hinted.traversal.hybrid_patience == 2


def test_plan_request_matches_jax_and_never_samples(ds, grid):
    jeng, peng = _engines(ds, calibrated=False)
    for eng in (jeng, peng):
        assert eng.plan_request(64, theta=grid[2]) == ("es_sws", "off")
    _feed(jeng.cost_table, JJoinStats)
    _feed(peng.cost_table, JoinStats)
    for n in (1, 64, 500):
        for method, quant in ((None, None), ("es", None), (None, "sq8"),
                              ("es_sws", "sq8")):
            kw = dict(theta=grid[2], method=method, quant=quant)
            assert peng.plan_request(n, **kw) == jeng.plan_request(n, **kw)
    assert peng.plan_request(64, theta=grid[2]) == ("es_sws", "off")
    assert peng._estimator is None or peng._estimator._store is None


@pytest.mark.parametrize("quant", ["off", "sq8"])
@pytest.mark.parametrize("method", ["nlj", "es_sws"])
def test_planned_pairs_equal_hand_tuned(ds, grid, method, quant):
    """A planned config (wave snapped, band cap seeded from the estimate)
    emits the pairs of the hand-tuned one."""
    eng = JoinEngine(ds.Y, build_kw=BK, device=CPU, metrics=Metrics())
    hand = JoinConfig(method=method, theta=grid[3], quant=quant,
                      wave_size=48)
    want = eng.join(ds.X, hand)
    planned = eng.plan_config(ds.X, hand, method=method, quant=quant)
    assert planned.wave_size != hand.wave_size
    got = eng.join(ds.X, planned)
    assert got.pair_set() == want.pair_set()
    assert got.stats.overflow_retries == 0
    assert len(got.pairs) > 0


@pytest.mark.parametrize("extra", [["--method", "es_sws"],
                                   ["--method", "es_mi", "--quant", "sq8",
                                    "--theta-q", "1"]])
def test_launcher_plan_auto_matches_jax(capsys, extra):
    argv = ["--n-data", "600", "--n-query", "96", "--dim", "16",
            "--engine-spec", "ci", "--theta-q", "3", "--plan", "auto",
            *extra]
    assert launch.main(["--device", "cpu", *argv]) == 0
    got = capsys.readouterr().out
    assert jlaunch.main(argv) == 0
    want = capsys.readouterr().out

    def lines(out):
        return [re.sub(r" in [0-9.]+s", "", ln) for ln in out.splitlines()
                if ln.startswith(("[join] plan auto", "[join] recall"))
                or re.match(r"\[join\] [0-9]+ pairs", ln)]
    assert lines(got) == lines(want) and len(lines(got)) == 3
