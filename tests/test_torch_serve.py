"""The serving path of the PyTorch port against the JAX package.

``JoinService`` admits requests from many tenants, snaps each onto a
ladder of wave sizes and serves each tenant's round through its
``JoinEngine.submit_many``. Two tenants (manifold 600 × 16 and clustered
500 × 16) are loaded in both packages' services; each port tenant adopts
the JAX tenant's G_Y and its int8 store over G_Y (carried across as
arrays), so both services traverse the same graph. Then:

  * every pinned request of a shuffled two-tenant stream (f32 and sq8
    alternating, two θ per tenant) gives the JAX service's pairs,
    ``qid_offset``, ``bucket``, ``n_dist``, ``n_iters``, ``n_rerank`` and
    cache counters, with the port's wave pipeline off and on; the JAX
    service runs with overlap off (with overlap on it drops band entries
    after a cap retry, ROADMAP Queue C); the ``serve_join.*`` stats equal
    too;
  * requests that leave ``method``/``quant`` to the planner, and reduced
    recall budgets, give the pairs of a direct ``submit`` replay under
    ``svc.plan(req)`` (the planner picks by each package's own measured
    seconds, so these are held to the port's own plan);
  * interleaved dispatch (``submit_many``) equals per-request ``submit``;
    invalid requests and a full queue are rejected and counted, never
    raised; unload and LRU eviction drop the tenant's caches (a reload
    builds again); ``_MetricsDict`` writes through; the env flags; the
    kernel-build count stays flat after warmup and counts a library
    build, not the load of a cached one;
  * ``launch.serve_join`` prints ``repro.launch.serve_join``'s lines on
    the same arguments (times and the compile counter's wording apart).
"""
import dataclasses
import random
import re
import stat
import sys

import numpy as np
import pytest
import torch

from repro.configs.vectorjoin import preset as jpreset
from repro.core.types import TraversalConfig as JTraversalConfig
from repro.data.vectors import make_dataset, thresholds
from repro.launch import serve_join as jlaunch
from repro.obs import metrics as jmetrics
from repro.serve import JoinRequest as JJoinRequest
from repro.serve import JoinService as JJoinService
from repro.serve import ServiceConfig as JServiceConfig
from repro_torch.configs.vectorjoin import preset
from repro_torch.core.types import (TraversalConfig, env_flag,
                                    graph_index_from_numpy)
from repro_torch.kernels import _build
from repro_torch.launch import serve_join as launch
from repro_torch.obs import metrics as obs_metrics
from repro_torch.quant import QuantStore
from repro_torch.serve import (JoinRequest, JoinService, RequestRejected,
                               ServiceConfig)
from repro_torch.serve.engine import _MetricsDict
from repro_torch.serve.join_service import snap_budget

CPU = torch.device("cpu")
TC = dict(beam_width=32, expand_per_iter=4, pool_cap=512, hybrid_beam=32,
          seeds_max=8, max_iters=1024)
BK = dict(k=12, degree=8)
BUCKETS = (16, 32)
QUANTS = ("off", "sq8")
FIELDS = ("n_dist", "n_iters", "n_rerank", "cache_hits", "cache_misses",
          "cache_evictions", "cache_tombstones", "peak_cache_entries")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the port's CPU tests run many small ops, and
    with the suite's parallel workers on every core, thread-pool regions
    waiting for descheduled threads slow them tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _base_cfg(overlap=True):
    return dataclasses.replace(preset("es_sws", theta=1.0),
                               traversal=TraversalConfig(**TC),
                               overlap=overlap)


@pytest.fixture(scope="module")
def datasets():
    return {"ta": make_dataset("manifold", n_data=600, n_query=64, dim=16,
                               seed=11),
            "tb": make_dataset("clustered", n_data=500, n_query=64, dim=16,
                               seed=12)}


@pytest.fixture(scope="module")
def thetas(datasets):
    return {n: [float(t) for t in thresholds(ds, 7)[1:4:2]]
            for n, ds in datasets.items()}         # two θ per tenant


def _requests(datasets, thetas, n: int = 12, seed: int = 3, **kw) -> list:
    """A shuffled two-tenant stream, quants alternating, every request
    pinned to es_sws; ``kw`` overrides fields per request."""
    rng = random.Random(seed)
    out = []
    for uid in range(n):
        name = rng.choice(sorted(datasets))
        k = rng.randint(1, 40)                        # 1-3 waves of 16
        lo = rng.randint(0, 64 - k)
        out.append(dict(uid=uid, tenant=name,
                        X=np.asarray(datasets[name].X, np.float32)[lo:lo + k],
                        theta=rng.choice(thetas[name]), method="es_sws",
                        quant=QUANTS[uid % 2]))
    for r in out:
        r.update(kw)
    return out


@pytest.fixture(scope="module")
def ref(datasets, thetas):
    """The JAX service (overlap off) after warmup and one served stream,
    with each tenant's G_Y and int8 store over G_Y."""
    base = dataclasses.replace(jpreset("es_sws", theta=1.0),
                               traversal=JTraversalConfig(**TC),
                               overlap=False)
    svc = JJoinService(JServiceConfig(buckets=BUCKETS),
                       metrics=jmetrics.Metrics())
    for name, ds in datasets.items():
        svc.load(name, ds.Y, build_kw=BK, default=base,
                 engine_kw=dict(carry_window=64))
        svc.warmup(name, thetas=thetas[name], quants=QUANTS)
    for r in _requests(datasets, thetas):
        assert svc.submit(JJoinRequest(**r))
    done = svc.run()
    carried = {}
    for name in datasets:
        eng = svc.engine(name)
        iy, st = eng._index_y, eng._tier_stores[("int8", "index_y")]
        carried[name] = (
            graph_index_from_numpy(
                np.asarray(iy.vecs), np.asarray(iy.nbrs),
                np.asarray(iy.start), np.asarray(iy.mean_nbr_dist),
                iy.n_data, CPU),
            QuantStore(q=torch.tensor(np.asarray(st.q)),
                       scales=torch.tensor(np.asarray(st.scales)),
                       norms=torch.tensor(np.asarray(st.norms)),
                       err=torch.tensor(np.asarray(st.err)),
                       group_size=int(st.group_size)))
    return done, dict(svc.stats), carried


def _service(datasets, carried=None, *, overlap=True, warm=None, **cfg_kw):
    """The port's service with both tenants on the CPU; with ``carried``
    each adopts the reference's G_Y and int8 store; ``warm`` maps tenant
    → θs to warm up (off and sq8)."""
    svc = JoinService(ServiceConfig(buckets=BUCKETS, **cfg_kw),
                      metrics=obs_metrics.Metrics())
    for name, ds in datasets.items():
        eng = svc.load(name, ds.Y, build_kw=BK, default=_base_cfg(overlap),
                       engine_kw=dict(carry_window=64, device=CPU))
        if carried:
            iy, store = carried[name]
            eng.adopt(index_y=iy)
            eng._tier_stores.put(("int8", "index_y"), store)
        if warm:
            svc.warmup(name, thetas=warm[name], quants=QUANTS)
    return svc


def _same(a, b, fields=FIELDS) -> None:
    assert a.pair_set() == b.pair_set(), a.uid
    assert (a.qid_offset, a.bucket, a.n_queries, a.ok) == (
        b.qid_offset, b.bucket, b.n_queries, b.ok), a.uid
    for f in fields:
        assert getattr(a.stats, f) == getattr(b.stats, f), (a.uid, f)


# -- the service against the reference's ---------------------------------


@pytest.mark.parametrize("overlap", [False, True])
def test_service_matches_jax_service(datasets, thetas, ref, overlap):
    want, want_stats, carried = ref
    svc = _service(datasets, carried, overlap=overlap, warm=thetas)
    assert all(svc.engine(n).n_index_builds == 0 for n in datasets)
    c0 = obs_metrics.compile_count()
    reqs = _requests(datasets, thetas)
    for r in reqs:
        assert svc.submit(JoinRequest(**r))
    done = svc.run()
    assert obs_metrics.compile_count() == c0
    assert len(done) == len(reqs) and all(sj.ok for sj in done.values())
    for r in reqs:
        _same(done[r["uid"]], want[r["uid"]])
    assert dict(svc.stats) == want_stats
    assert sum(sj.stats.n_rerank for sj in done.values()) > 0
    assert sum(sj.stats.cache_hits for sj in done.values()) > 0
    snap = svc.metrics_snapshot()
    assert snap["gauges"]["serve_join.completed"] == len(reqs)
    assert snap["histograms"]["serve_join.admission_seconds"]["count"] \
        == len(reqs)


def _replay(svc, reqs, done) -> None:
    """Each tenant's ``reset_stream``, then ``submit(X, svc.plan(req))``
    per request in the service's dispatch order: the served results."""
    for name in svc.tenants:
        eng = svc.engine(name)
        eng.reset_stream()
        for r in (r for r in reqs if r.tenant == name):
            direct = eng.submit(r.X, svc.plan(r))
            sj = done[r.uid]
            assert set(map(tuple, direct.pairs.tolist())) == sj.pair_set()
            for f in FIELDS:
                assert getattr(direct.stats, f) == getattr(sj.stats, f)


def test_planned_and_budgeted_requests_equal_direct_replay(datasets, thetas,
                                                           ref):
    """Requests that leave method and/or quant to the planner, and
    reduced recall budgets (patience scaled), served = a direct replay of
    the port's own plans."""
    svc = _service(datasets, ref[2], warm=thetas)
    reqs = [JoinRequest(**r) for r in _requests(datasets, thetas, seed=5)]
    for i, r in enumerate(reqs):
        if i % 4 == 1:
            r.method = r.quant = None
        elif i % 4 == 2:
            r.method = None
        elif i % 4 == 3:
            r.recall_budget = 0.5
    plans = {r.uid: svc.plan(r) for r in reqs}
    assert plans[1].method == "es_sws"               # the calibrated point
    assert plans[3].traversal.patience == max(
        1, round(_base_cfg().traversal.patience * 0.5))
    for r in reqs:
        assert svc.submit(r)
    done = svc.run()
    assert all(sj.ok for sj in done.values())
    assert {r.uid: svc.plan(r) for r in reqs} == plans
    _replay(svc, reqs, done)


def test_interleaved_dispatch_equals_sequential_submit(datasets, thetas,
                                                       ref, monkeypatch):
    out = []
    for flag in ("on", "off"):
        monkeypatch.setenv("REPRO_SERVE_INTERLEAVE", flag)
        svc = _service(datasets, ref[2], warm=thetas)
        assert svc.interleave is (flag == "on")
        for r in _requests(datasets, thetas, seed=7):
            assert svc.submit(JoinRequest(**r))
        out.append(svc.run())
    for uid, sj in out[0].items():
        _same(sj, out[1][uid])


def test_budget_snapping_and_buckets(datasets):
    assert [snap_budget(b) for b in (0.0, 0.6, 0.66, 2.0)] == \
        [0.25, 0.5, 0.75, 1.0]
    svc = _service(datasets)
    X = np.asarray(datasets["ta"].X, np.float32)
    base = svc.engine("ta").default
    for n, want in ((1, 16), (16, 16), (17, 32), (100, 32)):
        assert svc.bucket_for(n) == want
        cfg = svc.plan(JoinRequest(uid=0, tenant="ta", X=X[:n], theta=1.0))
        assert cfg.wave_size == want
        assert cfg.traversal is base.traversal        # full budget
    ok = JoinRequest(uid=0, tenant="ta", X=X[:4], theta=1.0, wave=32)
    assert svc.plan(ok).wave_size == 32               # pinned, not snapped
    cfg = svc.plan(JoinRequest(uid=1, tenant="ta", X=X[:8], theta=1.0))
    assert (cfg.method, cfg.quant) == ("es_sws", base.quant)  # uncalibrated
    eng = svc.engine("ta")
    assert eng._estimator is None or eng._estimator._store is None


# -- admission --------------------------------------------------------------


def test_rejections_are_recorded_never_raised(datasets):
    svc = _service(datasets, max_queue=2)
    X = np.asarray(datasets["ta"].X, np.float32)
    bad = [
        (JoinRequest(uid=0, tenant="nope", X=X[:4], theta=1.0),
         "not loaded"),
        (JoinRequest(uid=1, tenant="ta", X=X[:0], theta=1.0), "non-empty"),
        (JoinRequest(uid=2, tenant="ta", X=X[:4, :8], theta=1.0), "dim"),
        (JoinRequest(uid=3, tenant="ta", X=X[:4], theta=0.0), "theta"),
        (JoinRequest(uid=4, tenant="ta", X=X[:4], theta=1.0,
                     method="es_mi"), "not servable"),
        (JoinRequest(uid=5, tenant="ta", X=X[:4], theta=1.0,
                     method="zzz"), "unknown method"),
        (JoinRequest(uid=6, tenant="ta", X=X[:4], theta=1.0,
                     quant="zzz"), "quant"),
        (JoinRequest(uid=7, tenant="ta", X=X[:4], theta=1.0, wave=17),
         "pre-compiled bucket"),
        (JoinRequest(uid=8, tenant="ta", X=torch.from_numpy(X[:4, :8]),
                     theta=1.0), "dim"),
    ]
    for req, frag in bad:
        assert svc.submit(req) is False
        assert frag in svc.failed[req.uid]
        assert svc.done[req.uid].ok is False
        assert len(svc.done[req.uid].pairs) == 0
    assert svc.stats["rejected"] == len(bad)
    with pytest.raises(RequestRejected):
        svc.validate(bad[0][0])
    ok = JoinRequest(uid=10, tenant="ta", X=torch.from_numpy(X[:4]),
                     theta=1.0)
    assert svc.submit(ok)
    assert svc.submit(JoinRequest(uid=10, tenant="ta", X=X[:4],
                                  theta=1.0)) is False
    assert "duplicate" in svc.failed[10]
    assert svc.run()[10].ok                           # a tensor request


def test_late_reject_in_a_round_is_recorded(datasets):
    """A request whose plan fails at dispatch (the ladder changed after
    admission) is recorded as failed; the rest of its round is served."""
    svc = _service(datasets)
    X = np.asarray(datasets["ta"].X, np.float32)
    assert svc.submit(JoinRequest(uid=0, tenant="ta", X=X[:4], theta=1.0,
                                  wave=32))
    assert svc.submit(JoinRequest(uid=1, tenant="ta", X=X[:4], theta=1.0))
    svc.cfg = dataclasses.replace(svc.cfg, buckets=(16,))
    done = svc.run()
    assert done[0].ok is False and "pre-compiled bucket" in svc.failed[0]
    assert done[1].ok and svc.stats["completed"] == 1


def test_queue_overflow_backpressure(datasets):
    svc = _service(datasets, max_queue=2)
    X = np.asarray(datasets["ta"].X, np.float32)
    for uid in range(2):
        assert svc.submit(JoinRequest(uid=uid, tenant="ta", X=X[:4],
                                      theta=1.0))
    assert svc.stats["queue_depth"] == 2
    assert svc.submit(JoinRequest(uid=2, tenant="ta", X=X[:4],
                                  theta=1.0)) is False
    assert "queue full" in svc.failed[2]
    assert svc.stats["rejected"] == 1 and svc.stats["admitted"] == 2
    assert svc.metrics.gauge("serve_join.rejected").value == 1


# -- tenancy -----------------------------------------------------------------


def test_unload_and_lru_eviction_drop_caches(datasets):
    ds_a, ds_b = datasets["ta"], datasets["tb"]
    svc = JoinService(ServiceConfig(buckets=BUCKETS, max_tenants=1),
                      metrics=obs_metrics.Metrics())
    kw = dict(build_kw=BK, default=_base_cfg(),
              engine_kw=dict(device=CPU))
    eng_a = svc.load("ta", ds_a.Y, **kw)
    sq8 = dataclasses.replace(eng_a.default, quant="sq8")
    eng_a.warm_quant(ds_a.X, sq8)                     # G_Y and its store
    assert eng_a._index_y is not None and len(eng_a._tier_stores) == 1
    svc.load("tb", ds_b.Y, **kw)
    assert svc.tenants == ["tb"]                      # LRU evicted ta
    assert eng_a._index_y is None and len(eng_a._tier_stores) == 0
    assert svc.stats["tenant_evictions"] == 1
    with pytest.raises(KeyError):
        svc.engine("ta")
    eng_a.warm_quant(ds_a.X, sq8)                     # rebuilt on demand
    assert (eng_a.build_counts["index_y"], eng_a.build_counts["quant"]) \
        == (2, 2)
    eng_b = svc.engine("tb")
    eng_b.index_y()
    assert svc.unload("tb") is True
    assert eng_b._index_y is None and len(eng_b._tier_stores) == 0
    assert svc.unload("tb") is False
    assert svc.stats["tenants"] == 0
    again = svc.load("tb", ds_b.Y, **kw)              # a fresh engine
    assert again is not eng_b and again.n_index_builds == 0


def test_load_keeps_a_tensor_on_its_device(datasets):
    svc = JoinService(ServiceConfig(buckets=BUCKETS),
                      metrics=obs_metrics.Metrics())
    Y = torch.from_numpy(datasets["ta"].Y)
    eng = svc.load("ta", Y, engine_kw=dict(device=CPU))
    assert eng.Y.data_ptr() == Y.data_ptr()           # not copied


# -- plumbing ----------------------------------------------------------------


def test_metrics_dict_writes_through_and_rejects_removal():
    reg = obs_metrics.Metrics()
    d = _MetricsDict(reg, "t", a=1)
    assert reg.gauge("t.a").value == 1
    d["a"] += 2
    assert reg.gauge("t.a").value == 3
    d.update(b=5, a=4)
    assert reg.gauge("t.b").value == 5 and reg.gauge("t.a").value == 4
    d.update({"c": 6}, a=7)
    assert reg.gauge("t.c").value == 6 and reg.gauge("t.a").value == 7
    assert d.setdefault("e", 9) == 9 and reg.gauge("t.e").value == 9
    assert d.setdefault("e", 0) == 9
    for op in (lambda: d.pop("a"), lambda: d.popitem(),
               lambda: d.clear(), lambda: d.__delitem__("a")):
        with pytest.raises(TypeError):
            op()
    assert d["a"] == 7


def test_env_flags(datasets, monkeypatch):
    monkeypatch.setenv("REPRO_SERVE_INTERLEAVE", "off")
    assert _service(datasets, interleave=True).interleave is False
    monkeypatch.setenv("REPRO_SERVE_INTERLEAVE", "")   # empty == unset
    assert _service(datasets, interleave=True).interleave is True
    assert _service(datasets, interleave=False).interleave is False
    svc = _service(datasets)
    monkeypatch.setenv("REPRO_SERVE_WARMUP", "0")
    assert svc.warmup("ta", thetas=[1.0]) == 0
    assert svc.engine("ta").n_index_builds == 0        # nothing ran
    monkeypatch.delenv("REPRO_SERVE_WARMUP")
    assert env_flag("REPRO_SERVE_WARMUP", True)


def test_warmup_runs_the_ladder_and_resets_the_stream(datasets, thetas, ref):
    svc = _service(datasets, ref[2])
    eng = svc.engine("ta")
    n = svc.warmup("ta", thetas=thetas["ta"], quants=QUANTS)
    assert n == len(BUCKETS) * len(thetas["ta"]) * len(QUANTS)
    assert eng.n_submitted == 0 and not eng._stream_cache
    assert eng.serve_stats["batches"] == n
    assert len(eng._cap_estimates) == len(thetas["ta"])   # sq8 caps seeded
    assert {(e.method, e.quant) for e in eng.cost_table.entries()} == {
        ("es_sws", "off"), ("es_sws", "sq8")}


def _fake_nvcc(path) -> str:
    """An ``nvcc`` stand-in that writes each ``-o`` target."""
    script = path / "nvcc"
    script.write_text(f"#!{sys.executable}\nimport sys\n"
                      "a = sys.argv\n"
                      "open(a[a.index('-o') + 1], 'wb').close()\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


def test_compile_count_counts_library_builds_not_loads(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(obs_metrics, "_DEFAULT", obs_metrics.Metrics())
    monkeypatch.setattr(obs_metrics, "_compile_counter_enabled", False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: _fake_nvcc(tmp_path))
    for name in ("build_seconds", "build_log"):       # restored after
        monkeypatch.setattr(_build, name, getattr(_build, name))
    _build.build()
    assert obs_metrics.compile_count() == 0           # not enabled yet
    (_build.library_path()).unlink()
    JoinService(metrics=obs_metrics.Metrics())        # enables it
    assert obs_metrics.compile_count() == 0
    _build.build()
    assert obs_metrics.compile_count() == 1
    _build.build()                                    # cached: a load
    assert obs_metrics.compile_count() == 1


# -- the launcher ------------------------------------------------------------


def _launch_lines(out: str) -> list[str]:
    """The launcher's lines with wall times, rates and the compile
    counter's wording taken out."""
    subs = ((r" in [0-9.]+s", ""), (r" \([0-9]+ q/s\)", ""),
            (r"latency mean=[0-9.]+ms", "latency"),
            (r"\([0-9]+ (kernel builds|compiles)\)", "(builds)"),
            (r"(kernel builds|compiles) during serve", "builds during serve"),
            (r"[0-9]+ trace events", "trace events"))
    lines = []
    for ln in out.splitlines():
        if ln.startswith("[serve_join]"):
            for a, b in subs:
                ln = re.sub(a, b, ln)
            lines.append(ln)
    return lines


@pytest.mark.parametrize("extra", [["--quants", "off,sq8"],
                                   ["--plan", "auto", "--no-interleave"]])
def test_launcher_matches_jax(capsys, tmp_path, monkeypatch, extra):
    # each launcher on a fresh default registry: its occupancy histogram
    # would otherwise hold every earlier default-registry service of the
    # process
    monkeypatch.setattr(obs_metrics, "_DEFAULT", obs_metrics.Metrics())
    monkeypatch.setattr(jmetrics, "_DEFAULT", jmetrics.Metrics())
    argv = ["--n-data", "500", "--dim", "16", "--requests", "8",
            "--max-request", "40", "--buckets", "16,32", *extra]
    assert launch.main(["--device", "cpu", *argv,
                        "--metrics-json", str(tmp_path / "m.json")]) == 0
    got = capsys.readouterr().out
    assert jlaunch.main(argv + ["--metrics-json",
                                str(tmp_path / "m.json")]) == 0
    want = capsys.readouterr().out
    assert _launch_lines(got) == _launch_lines(want)
    assert "kernel builds during serve: 0 (flat)" in got
    assert len(_launch_lines(got)) == 6


def test_launcher_refuses_shards(capsys):
    with pytest.raises(SystemExit) as e:
        launch.main(["--device", "cpu", "--shards", "2"])
    assert e.value.code == 2
    assert "only 1 device(s) visible" in capsys.readouterr().err
