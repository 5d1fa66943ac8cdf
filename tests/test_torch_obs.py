"""Observability of the PyTorch port against the JAX package.

  * ``JoinStats.publish`` / ``from_metrics`` round trip through a
    registry, field for field the reference's (a second publish adds
    counters, keeps high-water marks, overwrites per-shard gauges);
  * ``JoinEngine.metrics_snapshot`` has the reference's counter, gauge,
    histogram and ``cost_table`` keys after the same joins (streamed es_sws,
    es_hws, nlj; f32 and sq8) on the reference's G_Y and int8 stores
    carried across, and ``cumulative_stats`` equals the reference's in
    every work counter and is the sum of the port's own joins' stats;
  * tracing observes and never schedules: traced and untraced joins give
    the same pairs and counters (es_mi and es_sws, f32 and sq8, overlap on
    and off), and ``Tracer.export`` writes the Chrome/Perfetto schema;
  * ``launch.join --trace --metrics-dump`` writes the spans, lanes and
    event count and prints the metric names of ``repro.launch.join`` on
    the same arguments.
"""
import dataclasses
import json
import re
import time

import numpy as np
import pytest
import torch

from repro.core import JoinConfig as JJoinConfig
from repro.core import TraversalConfig as JTraversalConfig
from repro.core import build_index as jbuild_index
from repro.core.types import JoinStats as JJoinStats
from repro.data.vectors import make_dataset, thresholds
from repro.engine import JoinEngine as JJoinEngine
from repro.launch import join as jlaunch
from repro.obs import metrics as jmetrics
from repro_torch.core import JoinConfig, TraversalConfig
from repro_torch.core.types import JoinStats, graph_index_from_numpy
from repro_torch.engine import JoinEngine
from repro_torch.launch import join as launch
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.quant import QuantStore

CPU = torch.device("cpu")
BK = dict(k=12, degree=8)
TC = dict(beam_width=32, expand_per_iter=4, pool_cap=512, hybrid_beam=32,
          seeds_max=8, max_iters=1024)
SECONDS = tuple(f.name for f in dataclasses.fields(JoinStats)
                if f.name.endswith("_seconds"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the port's CPU tests run many small ops, and
    with the suite's parallel workers on every core, thread-pool regions
    waiting for descheduled threads slow them tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracer_hygiene():
    """No test may leak an enabled tracer into the rest of the suite."""
    yield
    obs_trace.disable()


@pytest.fixture(scope="module")
def ds():
    return make_dataset("manifold", n_data=600, n_query=96, dim=16, seed=42)


@pytest.fixture(scope="module")
def theta(ds):
    return float(thresholds(ds, 3)[1])


@pytest.fixture(scope="module")
def jiy(ds):
    return jbuild_index(ds.Y, **BK)


def _cfgs(method, theta, quant="off", overlap=False):
    kw = dict(method=method, theta=theta, wave_size=32, quant=quant,
              overlap=overlap)
    return (JJoinConfig(traversal=JTraversalConfig(**TC), **kw),
            JoinConfig(traversal=TraversalConfig(**TC), **kw))


def _port_store(jstore) -> QuantStore:
    return QuantStore(q=torch.tensor(np.asarray(jstore.q)),
                      scales=torch.tensor(np.asarray(jstore.scales)),
                      norms=torch.tensor(np.asarray(jstore.norms)),
                      err=torch.tensor(np.asarray(jstore.err)),
                      group_size=int(jstore.group_size))


# -- the registry bridge ------------------------------------------------------


def test_publish_from_metrics_roundtrip_matches_jax():
    kw = dict(n_dist=7, greedy_seconds=0.5, peak_cache_entries=3,
              band_occ_per_shard=(4, 9), cache_hits=2, cache_misses=1,
              bytes_band=128, wait_seconds=0.25, overflow_retries=1)
    s, js = JoinStats(**kw), JJoinStats(**kw)
    m, jm = obs_metrics.Metrics(), jmetrics.Metrics()
    s.publish(m)
    js.publish(jm)
    assert JoinStats.from_metrics(m) == s
    later = JoinStats(n_dist=5, peak_cache_entries=2,
                      band_occ_per_shard=(1, 2, 3))
    later.publish(m)
    JJoinStats(**dataclasses.asdict(later)).publish(jm)
    back = JoinStats.from_metrics(m)
    assert dataclasses.asdict(back) == dataclasses.asdict(
        JJoinStats.from_metrics(jm))
    assert back.n_dist == 12 and back.peak_cache_entries == 3
    assert back.band_occ_per_shard == (1, 2, 3)
    assert m.value("join.shard_band_imbalance") == pytest.approx(1.5)
    assert m.snapshot() == jm.snapshot()
    assert m.prometheus_text() == jm.prometheus_text()


def test_every_stats_field_is_the_references():
    assert [f.name for f in dataclasses.fields(JoinStats)] == \
        [f.name for f in dataclasses.fields(JJoinStats)]
    assert (JoinStats._MERGE_MAX, JoinStats._MERGE_CAT) == (
        JJoinStats._MERGE_MAX, JJoinStats._MERGE_CAT)
    assert JoinStats.from_metrics(obs_metrics.Metrics()) == JoinStats()


# -- engine surfaces ----------------------------------------------------------


def _drive(eng, method, cfg, X) -> list:
    """es_sws streams three batches; the others join once."""
    if method == "es_sws":
        return [eng.submit(X[b0:b0 + 40], cfg) for b0 in range(0, 96, 40)]
    return [eng.join(X, cfg)]


@pytest.mark.parametrize("quant", ["off", "sq8"])
@pytest.mark.parametrize("method", ["es_sws", "es_hws", "nlj"])
def test_snapshot_and_cumulative_stats_match_jax(ds, theta, jiy, method,
                                                 quant):
    jcfg, cfg = _cfgs(method, theta, quant)
    jeng = JJoinEngine(ds.Y, build_kw=BK, metrics=jmetrics.Metrics())
    jeng.adopt(index_y=jiy)
    _drive(jeng, method, jcfg, ds.X)
    eng = JoinEngine(ds.Y, build_kw=BK, device=CPU,
                     metrics=obs_metrics.Metrics())
    eng.adopt(index_y=graph_index_from_numpy(
        np.asarray(jiy.vecs), np.asarray(jiy.nbrs), np.asarray(jiy.start),
        np.asarray(jiy.mean_nbr_dist), jiy.n_data, CPU))
    for key, store in jeng._tier_stores.items():
        eng._tier_stores.put(key, _port_store(store))
    res = _drive(eng, method, cfg, ds.X)

    want, got = jeng.metrics_snapshot(), eng.metrics_snapshot()
    assert set(got) == set(want) and "cost_table" in got
    for section in got:
        # the reference built its tier stores (misses), the port was given
        # them (hits)
        assert ({k for k in got[section] if ".tier_store." not in k}
                == {k for k in want[section] if ".tier_store." not in k}), \
            section
    assert sum(v for k, v in got["counters"].items()
               if ".tier_store." in k) == \
        sum(v for k, v in want["counters"].items() if ".tier_store." in k)
    assert got["counters"]["engine.queries"] == ds.X.shape[0]
    jcum, cum = jeng.cumulative_stats(), eng.cumulative_stats()
    for f in dataclasses.fields(JoinStats):
        if f.name not in SECONDS:
            assert getattr(cum, f.name) == getattr(jcum, f.name), f.name
    total = JoinStats()
    for r in res:
        total = total.merge(r.stats)
    assert cum == total


@pytest.mark.parametrize("carry_window", [4096, 16])
def test_cumulative_stats_is_the_sum_of_the_batches(ds, theta, carry_window):
    eng = JoinEngine(ds.Y, build_kw=BK, carry_window=carry_window,
                     device=CPU, metrics=obs_metrics.Metrics())
    cfg = _cfgs("es_sws", theta, overlap=True)[1]
    tot = JoinStats()
    for b0 in range(0, ds.X.shape[0], 40):
        tot = tot.merge(eng.submit(ds.X[b0:b0 + 40], cfg).stats)
    assert tot.cache_hits + tot.cache_misses > 0
    if carry_window == 16:
        assert tot.cache_evictions > 0
    assert eng.cumulative_stats() == tot
    assert eng.metrics.value("engine.batches") == 3


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("method", ["es_mi", "es_sws"])
def test_join_seconds_cover_the_traversal(ds, theta, monkeypatch, method,
                                          overlap):
    """A join's ``total_seconds`` (what the cost table, and so the planner,
    prices) covers its host-stepped traversal loops with overlap on too:
    there they count as ``wait_seconds``, as the reference's host waits
    at the fetch, and off as ``expand_seconds``. Each range expansion is
    made to take at least 20 ms longer."""
    from repro_torch.core import traversal
    expand, calls = traversal.range_expand, []

    def slow(*a, **kw):
        calls.append(1)
        time.sleep(0.02)
        return expand(*a, **kw)
    eng = JoinEngine(ds.Y, build_kw=BK, device=CPU,
                     metrics=obs_metrics.Metrics())
    cfg = _cfgs(method, theta, overlap=overlap)[1]
    eng.join(ds.X, cfg)                          # the indexes, unpatched
    monkeypatch.setattr(traversal, "range_expand", slow)
    st = eng.join(ds.X, cfg).stats
    assert calls and st.total_seconds >= 0.02 * len(calls)
    loop_s = st.wait_seconds if overlap else st.expand_seconds
    assert loop_s >= 0.02 * len(calls)


# -- tracing -----------------------------------------------------------------


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("quant", ["off", "sq8"])
@pytest.mark.parametrize("method", ["es_mi", "es_sws"])
def test_traced_equals_untraced(ds, theta, method, quant, overlap):
    eng = JoinEngine(ds.Y, build_kw=BK, device=CPU,
                     metrics=obs_metrics.Metrics())
    cfg = _cfgs(method, theta, quant, overlap)[1]
    plain = eng.join(ds.X, cfg)
    with obs_trace.tracing() as tr:
        traced = eng.join(ds.X, cfg)
    assert traced.pair_set() == plain.pair_set()
    for f in ("n_dist", "n_iters", "n_rerank", "cache_hits",
              "cache_misses", "bytes_assembly"):
        assert getattr(traced.stats, f) == getattr(plain.stats, f), f
    assert tr.n_events > 0
    assert {"wave/device", "wave/assemble"} <= {
        e["name"] for evs in tr.lanes().values() for e in evs}


def test_perfetto_export_schema(ds, theta, tmp_path):
    eng = JoinEngine(ds.Y, build_kw=BK, device=CPU,
                     metrics=obs_metrics.Metrics())
    with obs_trace.tracing() as tr:
        eng.join(ds.X, _cfgs("es_mi", theta, "sq8", overlap=True)[1])
    path = tmp_path / "trace.json"
    tr.export(str(path))
    evs = json.loads(path.read_text())["traceEvents"]
    assert isinstance(evs, list) and evs
    lanes = {e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"traversal", "assembly"} <= lanes
    assert any(e["ph"] == "M" and e["name"] == "process_name" for e in evs)
    for e in evs:
        if e["ph"] == "X":
            assert e["ts"] >= 0 and e["dur"] >= 0
        elif e["ph"] == "i":
            assert e["s"] == "t"
        if "args" in e:
            json.dumps(e["args"])
    prev = -1.0                                  # the device lane is serial
    for ev in tr.lanes()["traversal"]:
        if ev["dur_ns"]:
            assert ev["ts_ns"] >= prev
            prev = ev["ts_ns"] + ev["dur_ns"]


# -- the launcher ------------------------------------------------------------


def _trace_summary(path) -> tuple:
    evs = json.loads(path.read_text())["traceEvents"]
    return (sorted({(e["ph"], e["name"]) for e in evs if e["ph"] != "M"}),
            sorted(e["args"]["name"] for e in evs
                   if e["ph"] == "M" and e["name"] == "thread_name"))


def _metric_names(out: str) -> set:
    return {re.split(r"[ {]", ln)[0] for ln in out.splitlines()
            if ln and not ln.startswith(("[", "#"))}


@pytest.mark.parametrize("method", ["es_sws", "es_mi"])
def test_launcher_trace_and_metrics_dump_match_jax(capsys, tmp_path,
                                                   monkeypatch, method):
    """Each launcher on a fresh default registry (the dump prints the
    process-global one): the same metric names, spans, lanes and trace
    event count, and the same result lines."""
    argv = ["--n-data", "600", "--n-query", "96", "--dim", "16",
            "--engine-spec", "ci", "--theta-q", "3", "--method", method,
            "--quant", "sq8", "--metrics-dump"]
    monkeypatch.setattr(obs_metrics, "_DEFAULT", obs_metrics.Metrics())
    monkeypatch.setattr(jmetrics, "_DEFAULT", jmetrics.Metrics())
    # a JAX JoinService built earlier in this process (another test file
    # of the same worker) leaves its XLA-compile listener installed, and
    # it counts the JAX launcher's compiles as jax_compiles; the launcher
    # itself registers no such metric
    listener = jmetrics._compile_listener_installed
    assert launch.main(["--device", "cpu", *argv, "--trace",
                        str(tmp_path / "p.json")]) == 0
    got = capsys.readouterr().out
    assert jlaunch.main(argv + ["--trace", str(tmp_path / "j.json")]) == 0
    want = capsys.readouterr().out
    assert _metric_names(got) == (_metric_names(want)
                                  - ({"jax_compiles"} if listener else set()))
    assert {"join_n_dist", "engine_joins", "wave_pairs_bucket"} <= \
        _metric_names(got)
    assert _trace_summary(tmp_path / "p.json") == \
        _trace_summary(tmp_path / "j.json")

    def lines(out):
        return [re.sub(r" in [0-9.]+s| to \S+", "", ln)
                for ln in out.splitlines()
                if re.match(r"\[join\] ([0-9]+ pairs|wrote|recall)", ln)]
    assert lines(got) == lines(want) and len(lines(got)) == 3
