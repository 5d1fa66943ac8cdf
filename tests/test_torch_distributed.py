"""The sharded join and the one-shot API of the PyTorch port against the JAX
package.

The reference side is one subprocess with eight forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``; the suite's own
process must see one device). On the reference's data (manifold, n_data
1501, uneven for 2, 4 and 8 shards; d = 40; seed 42; its θ,
``thresholds(ds, 3)[0]``, which puts pair (18, 733) one f32 ulp outside
θ) it writes an npz of: the JAX engine's sharded MI joins at 2 and 4
shards under every filtering mode (overlap off, the ROADMAP Queue C
caveat) with their per-shard indexes and tier stores, the driver at a
second θ with band and merge caps of 2 (both retries), a sharded
``submit`` over four batches (es_mi with each batch's per-shard indexes,
and nlj), a hybrid mesh NLJ, and ``repro.launch.join --shards 2``.

The port side runs in this process on ``DeviceMesh``es of n × ``"cpu"``:
on the reference's per-shard indexes and stores carried across, the
sharded MI join gives the reference's pairs and counters; the mesh NLJ
gives the port's single-device exact NLJ; ``MeshPlan``, the estimator's
per-shard occupancy, the planner's mesh hint and the service's
sharded-tenant rules equal the reference's; ``vector_join`` and
``run_search_wave`` equal the reference's. Pairs within 16 f32 ulps of θ
are judged in float64, not avoided.
"""
import dataclasses
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import JoinConfig as JJoinConfig
from repro.core import JoinStats as JJoinStats
from repro.core import TraversalConfig as JTraversalConfig
from repro.core import distributed as JD
from repro.core import vector_join as jvector_join
from repro.data.vectors import make_dataset, thresholds
from repro.engine import JoinEngine as JJoinEngine
from repro.engine import run_search_wave as jrun_search_wave
from repro.plan import JoinPlanner as JJoinPlanner
from repro.plan import LshEstimator as JLshEstimator
from repro.serve import JoinRequest as JJoinRequest
from repro.serve import JoinService as JJoinService
from repro.serve import RequestRejected as JRequestRejected
from repro_torch.configs.vectorjoin import ENGINE_PRESETS, make_engine
from repro_torch.core import (JoinConfig, JoinStats, TraversalConfig,
                              exact_join_pairs, vector_join)
from repro_torch.core import distributed as D
from repro_torch.core.types import graph_index_from_numpy
from repro_torch.engine import JoinEngine, run_search_wave
from repro_torch.engine.engine import _fingerprint
from repro_torch.launch import join as launch
from repro_torch.obs.metrics import Metrics
from repro_torch.plan import JoinPlanner, LshEstimator
from repro_torch.quant.pdx import pdx_store_from_numpy
from repro_torch.quant.sketch import sketch_store_from_numpy
from repro_torch.quant.store import QuantStore
from repro_torch.serve import JoinRequest, JoinService, RequestRejected

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
BK = dict(k=24, degree=12)
TC = dict(beam_width=64, expand_per_iter=4, pool_cap=1024, hybrid_beam=64,
          seeds_max=8, max_iters=2048)
WAVE = 32
ULP16 = 16 * 2.0 ** -24          # 16 f32 ulps, relative
MI_RUNS = [(2, "es_mi_adapt", q) for q in ("off", "sq8", "pdx8", "sketch8")] \
    + [(4, "es_mi_adapt", q) for q in ("off", "sq8", "pdx8", "sketch8")] \
    + [(4, "es_mi", "off")]
DRIVER_RUNS = [(2, "sq8"), (4, "pdx8")]
# the counters the sharded MI join must share with the reference
MI_FIELDS = ("n_dist", "n_rerank", "overflow_retries", "n_overflow",
             "n_esc8", "n_rerank_gather", "bytes_band", "n_dims_scanned",
             "n_dims_total", "peak_cache_entries", "cache_hits",
             "cache_misses", "cache_evictions", "cache_tombstones",
             "bytes_allgather", "bytes_ppermute", "bytes_assembly",
             "bytes_psum", "quant_bytes")
STORE_FIELDS = {"int8": ("q", "scales", "norms", "err"),
                "sketch1": ("codes", "cum", "hs", "mu", "rot", "iso"),
                "pdx": ("perm", "vp", "ftail", "q", "scales", "qslab",
                        "qtail", "norms", "err")}
LAUNCH_ARGS = ["--n-data", "1200", "--n-query", "64", "--dim", "16",
               "--engine-spec", "ci", "--theta-q", "3", "--wave", "32"]

_REF_SCRIPT = textwrap.dedent("""
    import contextlib, dataclasses, io, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    from repro.core import JoinConfig, JoinStats, TraversalConfig
    from repro.core import distributed as D
    from repro.data.vectors import make_dataset, thresholds
    from repro.engine import JoinEngine
    from repro.engine.engine import _fingerprint
    from repro.launch import join as jl

    MI_RUNS, DRIVER_RUNS, FIELDS, STORE_FIELDS, TC, BK, WAVE, LAUNCH = \\
        {consts}
    out = {{}}
    ds = make_dataset("manifold", n_data=1501, n_query=64, dim=40, seed=42)
    theta, theta1 = (float(t) for t in thresholds(ds, 3)[:2])
    tc = TraversalConfig(**TC)
    fp = _fingerprint(ds.X)
    engines = {{}}
    for S, method, quant in MI_RUNS:
        eng = engines.setdefault(S, JoinEngine(ds.Y, build_kw=BK,
                                               n_shards=S))
        r = eng.join(ds.X, JoinConfig(method=method, theta=theta,
                                      traversal=tc, wave_size=WAVE,
                                      quant=quant, overlap=False))
        key = f"mi/{{S}}/{{method}}/{{quant}}"
        out[key + "/pairs"] = np.asarray(r.pairs, np.int64)
        out[key + "/band_occ_per_shard"] = np.asarray(
            r.stats.band_occ_per_shard)
        for f in FIELDS:
            out[key + "/" + f] = np.asarray(getattr(r.stats, f))
    for S, eng in engines.items():
        smi = eng.sharded_index(ds.X)
        for f, a in (("vecs", smi.vecs), ("nbrs", smi.nbrs),
                     ("start", smi.start), ("mnd", smi.mean_nbr_dist)):
            out[f"smi/{{S}}/{{f}}"] = np.asarray(a)
        for name, fields in STORE_FIELDS.items():
            st = eng._tier_stores[(name, "sharded", fp)]
            for f in fields + ("group_size", "slab", "dim"):
                if hasattr(st, f):
                    out[f"store/{{S}}/{{name}}/{{f}}"] = np.asarray(
                        getattr(st, f))
    # the driver at θ1 with band and merge caps of 2: both retries
    tc2 = dataclasses.replace(tc, rerank_cap=2)
    for S, quant in DRIVER_RUNS:
        eng = engines[S]
        smi = eng.sharded_index(ds.X)
        cfg = JoinConfig(theta=theta1, traversal=tc2, quant=quant)
        casc = eng.cascade_for(("sharded", fp), smi, cfg, JoinStats())
        pairs, st = D.distributed_mi_join(
            ds.X, smi, plan=D.MeshPlan(n_shards=S), theta=theta1, cfg=tc2,
            wave_size=WAVE, hybrid=True, cascade=casc, n_data=1501,
            overlap=False, merge_cap=2)
        key = f"drv/{{S}}/{{quant}}"
        out[key + "/pairs"] = np.asarray(pairs, np.int64)
        out[key + "/band_occ_per_shard"] = np.asarray(st.band_occ_per_shard)
        for f in FIELDS:
            out[key + "/" + f] = np.asarray(getattr(st, f))
    # streaming on 4 shards: 4 batches of 16
    for method in ("es_mi", "nlj"):
        e = JoinEngine(ds.Y, build_kw=BK, n_shards=4)
        cfg = JoinConfig(method=method, theta=theta, traversal=tc,
                         wave_size=WAVE, overlap=False)
        for b in range(4):
            Xb = ds.X[16 * b:16 * (b + 1)]
            r = e.submit(Xb, cfg)
            key = f"stream/{{method}}/{{b}}"
            out[key + "/pairs"] = np.asarray(r.pairs, np.int64)
            out[key + "/n_dist"] = np.asarray(r.stats.n_dist)
            if method == "es_mi":
                smi = e.sharded_index(Xb)
                for f, a in (("vecs", smi.vecs), ("nbrs", smi.nbrs),
                             ("start", smi.start),
                             ("mnd", smi.mean_nbr_dist)):
                    out[f"{{key}}/smi/{{f}}"] = np.asarray(a)
        out[f"stream/{{method}}/n_submitted"] = np.asarray(e.n_submitted)
        out[f"stream/{{method}}/cache"] = np.asarray(len(e._stream_cache))
    # a hybrid plan (2 data x 2 model) on the reference's own data
    rng = np.random.default_rng(0)
    HX = rng.normal(size=(96, 128)).astype(np.float32)
    HY = rng.normal(size=(771, 128)).astype(np.float32)
    plan = D.MeshPlan.plan(HY.shape[0], HX.shape[1], 4, traversal=False)
    ph, sh = D.distributed_nlj_join(HX, HY, plan, theta=14.9,
                                    wave_size=WAVE)
    out["hybrid/pairs"] = np.asarray(ph, np.int64)
    for f in ("bytes_psum", "bytes_allgather", "n_dist"):
        out["hybrid/" + f] = np.asarray(getattr(sh, f))
    Xp, _ = D._pad_cols(HX, plan.dim_shards, 64)
    Yp, _ = D._pad_cols(HY, plan.dim_shards, 64)
    out["hybrid/d2"] = np.asarray(D.make_hybrid_sq_dists(
        plan.make_mesh(), plan)(Xp, Yp))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jl.main(["--shards", "2"] + LAUNCH)
    out["launcher"] = np.asarray(buf.getvalue())
    np.savez(sys.argv[1], **out)
    print("REF_OK")
""")


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
def _private_registries(monkeypatch):
    """Fresh process-global metrics registries in both packages for every
    case, and no JAX compile listener (once installed it counts into the
    JAX registry for the rest of the process): the engines, services and
    launchers here publish into them, and other test files of the same
    worker compare those registries' contents."""
    from repro.obs import metrics as jmetrics
    from repro_torch.obs import metrics as pmetrics
    monkeypatch.setattr(jmetrics, "_DEFAULT", jmetrics.Metrics())
    monkeypatch.setattr(jmetrics, "enable_compile_counter", lambda: None)
    monkeypatch.setattr(pmetrics, "_DEFAULT", pmetrics.Metrics())
    monkeypatch.setattr(pmetrics, "_compile_counter_enabled", False)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    consts = repr((MI_RUNS, DRIVER_RUNS, MI_FIELDS, STORE_FIELDS, TC, BK,
                   WAVE, LAUNCH_ARGS))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT.format(consts=consts), str(path)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "REF_OK" in r.stdout, r.stdout + r.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def ds():
    return make_dataset("manifold", n_data=1501, n_query=64, dim=40,
                        seed=42)


@pytest.fixture(scope="module")
def thetas(ds):
    return tuple(float(t) for t in thresholds(ds, 3)[:2])


def _mesh(n: int) -> D.DeviceMesh:
    return D.DeviceMesh.on_device("cpu", n)


def _judge(got: np.ndarray, want: np.ndarray, X, Y, theta: float,
           n_data: int) -> int:
    """Pair sets equal but for pairs within 16 f32 ulps of θ² in float64;
    returns how many such pairs differ."""
    g = set(map(tuple, np.asarray(got).reshape(-1, 2).tolist()))
    w = set(map(tuple, np.asarray(want).reshape(-1, 2).tolist()))
    diff = sorted(g ^ w)
    X64, Y64 = np.asarray(X, np.float64), np.asarray(Y, np.float64)
    for q, y in diff:
        assert 0 <= y < n_data, (q, y)
        d2 = float(((X64[q] - Y64[y]) ** 2).sum())
        assert abs(d2 - theta ** 2) <= ULP16 * theta ** 2, (q, y, d2)
    return len(diff)


def _port_smi(ref, key: str, n_query: int) -> D.ShardedMergedIndex:
    vecs, nbrs = ref[key + "/vecs"], ref[key + "/nbrs"]
    S, M, _ = vecs.shape
    ss = M - n_query
    return D.ShardedMergedIndex(shards=tuple(
        graph_index_from_numpy(vecs[s], nbrs[s], ref[key + "/start"][s],
                               ref[key + "/mnd"][s], ss, CPU)
        for s in range(S)), shard_size=ss, n_query=n_query)


def _port_stores(ref, S: int) -> dict:
    """The reference's per-shard tier stores, carried across."""
    def z(name, f):
        return ref[f"store/{S}/{name}/{f}"]

    def t(a, dt=None):
        return torch.tensor(np.asarray(a, dt))
    int8 = tuple(QuantStore(q=t(z("int8", "q")[s]),
                            scales=t(z("int8", "scales")[s]),
                            norms=t(z("int8", "norms")[s]),
                            err=t(z("int8", "err")[s]),
                            group_size=int(z("int8", "group_size")))
                 for s in range(S))
    sk = tuple(sketch_store_from_numpy(
        z("sketch1", "codes")[s], z("sketch1", "cum")[s], z("sketch1", "hs"),
        z("sketch1", "mu")[s], z("sketch1", "rot"), z("sketch1", "iso"), CPU)
        for s in range(S))
    pd = tuple(pdx_store_from_numpy(
        *(z("pdx", f)[s] for f in STORE_FIELDS["pdx"]),
        slab=int(z("pdx", "slab")), dim=int(z("pdx", "dim")), device=CPU)
        for s in range(S))
    return {"int8": D.ShardedTierStore("int8", int8),
            "sketch1": D.ShardedTierStore("sketch1", sk,
                                          shared=("hs", "rot", "iso")),
            "pdx": D.ShardedTierStore("pdx", pd)}


def _sharded_engine(ds, ref, S: int, **kw) -> JoinEngine:
    eng = JoinEngine(ds.Y, build_kw=BK, n_shards=S, mesh=_mesh(S),
                     metrics=Metrics(), **kw)
    eng.adopt(X=ds.X, index_sharded=_port_smi(ref, f"smi/{S}", 64),
              tier_stores=_port_stores(ref, S))
    return eng


def _check_stats(stats: JoinStats, ref, key: str) -> None:
    for f in MI_FIELDS:
        assert getattr(stats, f) == int(ref[f"{key}/{f}"]), (key, f)
    assert stats.band_occ_per_shard == tuple(
        int(b) for b in ref[f"{key}/band_occ_per_shard"]), key


# -- MeshPlan, the mesh and its collectives -----------------------------------

PLAN_GRID = [(n_y, d, shards, trav)
             for n_y in (100, 1_000, 4_096 * 8, 10 ** 6)
             for d in (40, 64, 128, 256, 4096)
             for shards in (1, 2, 4, 8, 16, 0, "auto", None)
             for trav in (True, False)]


def _plan_or_error(cls, *args, **kw):
    try:
        p = cls.plan(*args, **kw)
    except ValueError as e:
        return ("error", "device" in str(e))
    return (p.n_shards, p.dim_shards, p.pool_combine, p.kind, p.n_devices)


def test_meshplan_matches_reference():
    for n_y, d, shards, trav in PLAN_GRID:
        for devices in (8, 16):
            assert (_plan_or_error(D.MeshPlan, n_y, d, shards,
                                   devices=devices, traversal=trav)
                    == _plan_or_error(JD.MeshPlan, n_y, d, shards,
                                      devices=devices, traversal=trav)), \
                (n_y, d, shards, trav, devices)
    for combine in ("all_gather", "ppermute"):
        assert (D.MeshPlan.plan(10 ** 6, 40, 2, devices=8, traversal=False,
                                pool_combine=combine).pool_combine
                == combine)
    with pytest.raises(ValueError, match="device"):
        D.MeshPlan.plan(10 ** 6, 40, 16, devices=8)
    with pytest.raises(ValueError, match=">= 1"):
        D.MeshPlan.plan(10 ** 6, 40, -1, devices=8)
    with pytest.raises(ValueError, match="pool combine"):
        D.MeshPlan(n_shards=2, pool_combine="psum")
    assert (D.HYBRID_ROW_FLOOR, D.POOL_COMBINE_RING_MIN,
            D.DEFAULT_MERGE_CAP) == (JD.HYBRID_ROW_FLOOR,
                                     JD.POOL_COMBINE_RING_MIN,
                                     JD.DEFAULT_MERGE_CAP)


def test_device_mesh_flattens_shard_axes_row_major():
    devs = [torch.device("cpu", i) for i in range(8)]
    mesh = D.DeviceMesh.of(devs, (2, 2, 2), ("pod", "data", "model"))
    assert mesh.axis_size(("pod", "data")) == 4 and mesh.size == 8
    # (pod, data) flattened row-major, model at 0: devices 0, 2, 4, 6
    assert mesh.shard_devices(("pod", "data")) == tuple(devs[0:8:2])
    assert mesh.shard_devices("model") == (devs[0], devs[1])
    assert mesh.device_at(pod=1, data=0, model=1) == devs[5]
    plan = D.MeshPlan(n_shards=2, dim_shards=4)
    m2 = plan.make_mesh(devs)
    assert m2.shape == (2, 4) and m2.axis_names == ("data", "model")
    assert D.DeviceMesh.on_device("cpu", 3).devices == (CPU,) * 3
    with pytest.raises(ValueError, match="do not fill"):
        D.DeviceMesh.of(devs[:3], (2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="no axis"):
        mesh.axis_size("rows")


def test_collectives_keep_rank_order():
    blocks = [torch.full((2, 3), float(r)) + torch.arange(3.0)
              for r in range(5)]
    want = torch.stack(blocks)
    assert torch.equal(D.all_gather(blocks, CPU), want)
    parts = [torch.rand(4, 6, generator=torch.Generator().manual_seed(r))
             for r in range(4)]
    assert torch.equal(D.psum(parts, CPU), torch.stack(parts).sum(0))


# -- the sharded index and the mesh MI join -------------------------------------

@pytest.mark.parametrize("S", [2, 4])
def test_sharded_builds_match_reference(ds, ref, S):
    """Each shard's table (sentinels included), navigating node and kNN
    lists are the reference's (the lists up to ties in float64); the
    neighbor tables differ in at most two rows a shard: the RNG prune's
    ``d(p, c) < d(q, c)`` sums in another order, and at S = 2 one pair of
    sums lies 6e-7 (relative) apart."""
    from repro.core import graph as jgraph
    from repro_torch.core import graph

    got = D.build_sharded_merged_index(ds.Y, ds.X, S, devices=_mesh(S)
                                       .devices, **BK)
    want = _port_smi(ref, f"smi/{S}", 64)
    assert got.shard_size == want.shard_size == -(-1501 // S)
    assert got.devices == (CPU,) * S
    for s, (g, w) in enumerate(zip(got.shards, want.shards)):
        assert torch.equal(g.vecs, w.vecs), s      # sentinels included
        assert int(g.start) == int(w.start) and g.n_data == w.n_data
        gd, gi = graph.exact_knn(g.vecs, BK["k"])
        wd, wi = jgraph.exact_knn(w.vecs.numpy(), BK["k"])
        v64 = g.vecs.double().numpy()
        for r in np.flatnonzero((gi.numpy() != np.asarray(wi)).any(axis=1)):
            dg = np.sort(((v64[gi[r]] - v64[r]) ** 2).sum(1))
            dw = np.sort(((v64[np.asarray(wi)[r]] - v64[r]) ** 2).sum(1))
            np.testing.assert_allclose(dg, dw, rtol=1e-6)
        rows = np.flatnonzero((g.nbrs != w.nbrs).any(dim=1).numpy())
        assert rows.size <= 2, (s, rows)
        np.testing.assert_allclose(g.mean_nbr_dist[~np.isin(
            np.arange(g.n_nodes), rows)], w.mean_nbr_dist[~np.isin(
                np.arange(g.n_nodes), rows)], rtol=1e-5)


@pytest.mark.parametrize("S,method,quant", MI_RUNS)
def test_sharded_mi_join_matches_reference(ds, ref, thetas, S, method,
                                           quant):
    key = f"mi/{S}/{method}/{quant}"
    cfg = JoinConfig(method=method, theta=thetas[0],
                     traversal=TraversalConfig(**TC), wave_size=WAVE,
                     quant=quant)
    for overlap in (False, True):
        eng = _sharded_engine(ds, ref, S)
        r = eng.join(ds.X, dataclasses.replace(cfg, overlap=overlap))
        _judge(r.pairs, ref[key + "/pairs"], ds.X, ds.Y, thetas[0], 1501)
        _check_stats(r.stats, ref, key)
        assert len(r.pairs) == len(r.pair_set())         # no duplicates
    assert eng.build_counts["sharded"] == 0              # adopted
    # the sharded cascade is the reference's byte for byte
    if quant != "off":
        assert r.stats.quant_bytes == int(ref[key + "/quant_bytes"]) > 0


@pytest.mark.parametrize("S,quant", DRIVER_RUNS)
def test_driver_retries_match_reference(ds, ref, thetas, S, quant):
    """Band and merge caps of 2 at the larger θ: both retries, counted as
    the reference counts them (every attempt's work and bytes)."""
    eng = _sharded_engine(ds, ref, S)
    tc = TraversalConfig(**dict(TC, rerank_cap=2))
    cfg = JoinConfig(theta=thetas[1], traversal=tc, quant=quant)
    smi = eng.sharded_index(ds.X)
    casc = eng.cascade_for(("sharded", _fingerprint(ds.X)), smi, cfg,
                           JoinStats())
    key = f"drv/{S}/{quant}"
    for overlap in (False, True):
        pairs, st = D.distributed_mi_join(
            torch.from_numpy(ds.X), smi, plan=D.MeshPlan(n_shards=S),
            theta=thetas[1], cfg=tc, wave_size=WAVE, hybrid=True,
            cascade=casc, n_data=1501, overlap=overlap, merge_cap=2)
        _judge(pairs, ref[key + "/pairs"], ds.X, ds.Y, thetas[1], 1501)
        if not overlap:
            _check_stats(st, ref, key)
            assert st.overflow_retries > 0 and st.n_iters > 0
    assert len(ref[key + "/pairs"]) > 100


def test_ring_combine_equals_all_gather(ds, ref, thetas):
    """The reference's ring label gives the same pairs (the port combines
    with ``all_gather`` either way) and routes the pool's bytes to
    ``bytes_ppermute``."""
    smi = _port_smi(ref, "smi/4", 64)
    tc = TraversalConfig(**TC)
    out = {}
    for combine in ("all_gather", "ppermute"):
        out[combine] = D.distributed_mi_join(
            ds.X, smi, plan=D.MeshPlan(n_shards=4, pool_combine=combine),
            theta=thetas[1], cfg=tc, wave_size=WAVE, n_data=1501)
    (pa, sa), (pp, sp) = out["all_gather"], out["ppermute"]
    assert np.array_equal(pa, pp) and len(pa) > 100
    assert sp.bytes_ppermute == sa.bytes_allgather > 0
    assert sp.bytes_allgather == 0 and sa.bytes_ppermute == 0
    with pytest.raises(ValueError, match="4 shards"):
        D.make_distributed_mi_join(_mesh(2), "data", smi, theta=1.0, cfg=tc)


# -- the mesh NLJ ------------------------------------------------------------------

@pytest.mark.parametrize("S", [2, 4, 8])
def test_mesh_nlj_equals_exact_nlj(ds, thetas, S):
    eng = JoinEngine(ds.Y, n_shards=S, mesh=_mesh(S), metrics=Metrics())
    single = exact_join_pairs(ds.X, ds.Y, thetas[1], device=CPU)
    for theta in thetas:
        r = eng.join(ds.X, JoinConfig(method="nlj", theta=theta,
                                      wave_size=WAVE))
        _judge(r.pairs, exact_join_pairs(ds.X, ds.Y, theta, device=CPU),
               ds.X, ds.Y, theta, 1501)
        assert r.stats.n_dist == 64 * 1501
        assert r.stats.band_occ_per_shard == (0,) * S
        meter = "bytes_ppermute" if S >= 8 else "bytes_allgather"
        assert getattr(r.stats, meter) > 0
    assert len(single) > 100
    # one step cache across thresholds: the Y blocks stay put
    assert eng._nlj_steps["key"][0] == eng._mesh_plan(traversal=False)


def _slab_partial_sq_dists(X, Y, k: int) -> torch.Tensor:
    """The hybrid partition's (k, B, N) per-group partials, with the
    arithmetic each model rank runs: the plain reference of the psum."""
    Xp, w = D._pad_cols(X, k, 64)
    Yp, _ = D._pad_cols(Y, k, 64)
    return torch.stack([D._group_partial(Xp[:, g * w:(g + 1) * w],
                                         Yp[:, g * w:(g + 1) * w])[0]
                        for g in range(k)])


def test_hybrid_psum_is_the_slab_sum(ref, monkeypatch):
    """The hybrid NLJ step's psum'd d² of each data shard is the slab
    partials' sum bit for bit, and the reference's within its tolerance."""
    rng = np.random.default_rng(0)
    HX = rng.normal(size=(96, 128)).astype(np.float32)
    HY = rng.normal(size=(771, 128)).astype(np.float32)
    plan = D.MeshPlan.plan(771, 128, 4, devices=4, traversal=False)
    assert (plan.kind, plan.n_shards, plan.dim_shards) == ("hybrid", 2, 2)
    seen, real = [], D.psum

    def spy(parts, device):
        seen.append(real(parts, device))
        return seen[-1]
    monkeypatch.setattr(D, "psum", spy)
    D.distributed_nlj_join(HX, HY, plan, theta=14.9, wave_size=96,
                           mesh=_mesh(4), merge_cap=1024)
    rows = 386                                   # ⌈771 / 2⌉, one sentinel
    d2 = [o for o in seen if o.dtype == torch.float32
          and tuple(o.shape) == (96, rows)]
    assert len(d2) == 2
    X = torch.from_numpy(HX)
    Y = torch.cat([torch.from_numpy(HY), torch.full((1, 128), 1e3)])
    for s, got in enumerate(d2):
        want = _slab_partial_sq_dists(X, Y[s * rows:(s + 1) * rows], 2)
        assert torch.equal(got, want.sum(0)), s          # bit for bit
    full = torch.cat(d2, dim=1)[:, :771]
    np.testing.assert_allclose(full.numpy(), ref["hybrid/d2"], rtol=1e-5,
                               atol=1e-3)
    # a width that is not whole slabs pads with zero columns
    Zp, w3 = D._pad_cols(torch.ones(3, 130), 2, 64)
    assert (w3, Zp.shape[1], float(Zp[:, 130:].abs().sum())) == (128, 256,
                                                                 0.0)


def test_hybrid_nlj_matches_exact_and_reference(ref):
    rng = np.random.default_rng(0)
    HX = rng.normal(size=(96, 128)).astype(np.float32)
    HY = rng.normal(size=(771, 128)).astype(np.float32)
    truth = exact_join_pairs(HX, HY, 14.9, device=CPU)
    eng = JoinEngine(HY, n_shards=4, mesh=_mesh(4), metrics=Metrics())
    r = eng.join(HX, JoinConfig(method="nlj", theta=14.9, wave_size=WAVE))
    plan = eng._mesh_plan(traversal=False)
    assert plan.kind == "hybrid"
    _judge(r.pairs, truth, HX, HY, 14.9, 771)
    assert r.stats.bytes_psum > 0
    # the driver at the reference's cold-start merge cap: its meters
    pairs, st = D.distributed_nlj_join(HX, HY, plan, theta=14.9,
                                       wave_size=WAVE, mesh=_mesh(4))
    _judge(pairs, ref["hybrid/pairs"], HX, HY, 14.9, 771)
    for f in ("bytes_psum", "bytes_allgather", "n_dist"):
        assert getattr(st, f) == int(ref["hybrid/" + f]) > 0, f


def test_hybrid_tail_bound_is_a_lower_bound():
    gen = torch.Generator().manual_seed(5)
    for d, k in ((128, 2), (256, 4), (192, 2)):
        X = torch.randn(40, d, generator=gen) * 3
        Y = torch.randn(50, d, generator=gen) + 0.5
        true = ((X.double()[:, None] - Y.double()[None]) ** 2).sum(-1)
        Xp, w = D._pad_cols(X, k, 64)
        Yp, _ = D._pad_cols(Y, k, 64)
        nx = (X * X).sum(-1, keepdim=True)
        ny = (Y * Y).sum(-1, keepdim=True)
        for g in range(k):
            part, xn, yn = D._group_partial(Xp[:, g * w:(g + 1) * w],
                                            Yp[:, g * w:(g + 1) * w])
            b = D.hybrid_tail_bound(part, xn, yn.T, nx, ny.T, d)
            assert (b.double() <= true).all(), (d, k, g)


# -- streaming, estimator, planner, service ----------------------------------------

@pytest.mark.parametrize("method", ["es_mi", "nlj"])
def test_sharded_submit_matches_reference(ds, ref, thetas, method):
    eng = JoinEngine(ds.Y, build_kw=BK, n_shards=4, mesh=_mesh(4),
                     metrics=Metrics())
    cfg = JoinConfig(method=method, theta=thetas[0],
                     traversal=TraversalConfig(**TC), wave_size=WAVE)
    for b in range(4):
        Xb = ds.X[16 * b:16 * (b + 1)]
        key = f"stream/{method}/{b}"
        if method == "es_mi":
            eng.adopt(X=Xb, index_sharded=_port_smi(ref, key + "/smi", 16))
        r = eng.submit(Xb, cfg)
        _judge(r.pairs, ref[key + "/pairs"], ds.X, ds.Y, thetas[0], 1501)
        assert np.all((r.pairs[:, 0] >= 16 * b) & (r.pairs[:, 0] < 16 * b
                                                   + 16))
        assert r.stats.n_dist == int(ref[key + "/n_dist"])
    assert eng.n_submitted == int(ref[f"stream/{method}/n_submitted"]) == 64
    assert len(eng._stream_cache) == int(ref[f"stream/{method}/cache"])
    with pytest.raises(NotImplementedError, match="single-device"):
        eng.submit(ds.X[:4], cfg, method="es_sws")
    # submit_many keeps the sharded engine on submit
    many = eng.submit_many([(ds.X[:16], cfg)])
    assert eng.n_submitted == 80 and many[0].pairs[:, 0].min(initial=64) \
        >= 64


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_estimator_shard_occ_and_mesh_hint_match_reference(ds, thetas, S):
    est = LshEstimator(torch.from_numpy(ds.Y))
    jest = JLshEstimator(ds.Y)
    for theta in thetas:
        got = est.estimate(ds.X, theta, n_shards=S)
        want = jest.estimate(ds.X, theta, n_shards=S)
        assert got.shard_occ == want.shard_occ
        assert got.shard_true_occ == want.shard_true_occ
        assert got.shard_imbalance == want.shard_imbalance
        assert len(got.shard_occ) == S
        for exact in (False, True):
            assert (got.merge_cap(1024, exact=exact)
                    == want.merge_cap(1024, exact=exact))
        for method in ("nlj", "es_mi_adapt"):
            for dim in (None, 40, 128, 256):
                assert (JoinPlanner._mesh_hint(method, got, S, dim)
                        == JJoinPlanner._mesh_hint(method, want, S, dim))


def test_engine_estimate_merge_cap_matches_reference(ds, thetas):
    eng = JoinEngine(ds.Y, n_shards=4, mesh=_mesh(4), metrics=Metrics())
    jeng = JJoinEngine(ds.Y, n_shards=4)
    for theta in thetas:
        cfg, jcfg = JoinConfig(theta=theta), JJoinConfig(theta=theta)
        for limit, exact in ((1024, False), (1501, True)):
            assert (eng.estimate_merge_cap(ds.X, cfg, limit=limit,
                                           exact=exact)
                    == jeng.estimate_merge_cap(ds.X, jcfg, limit=limit,
                                               exact=exact))
    p = eng.plan_config(ds.X, JoinConfig(theta=thetas[1]))
    assert p.method in ("nlj", "es_mi", "es_mi_adapt")
    assert eng.planner.plan(ds.X, theta=thetas[1], pool_cap=1024,
                            n_shards=4, dim=40).mesh_kind is not None


def test_sharded_tenant_rules_match_reference(ds, thetas):
    svc = JoinService(metrics=Metrics())
    jsvc = JJoinService()
    svc.load("t", ds.Y, engine_kw=dict(n_shards=4, mesh=_mesh(4)))
    jsvc.load("t", ds.Y, engine_kw=dict(n_shards=4))
    reqs = [dict(method=None, quant=None), dict(method="nlj", quant="off"),
            dict(method="es_mi_adapt", quant=None),
            dict(method="es_sws", quant="off"), dict(method="index",
                                                     quant="sq8")]
    for uid, kw in enumerate(reqs):
        r = JoinRequest(uid=uid, tenant="t", X=ds.X[:20], theta=thetas[0],
                        **kw)
        jr = JJoinRequest(uid=uid, tenant="t", X=ds.X[:20],
                          theta=thetas[0], **kw)
        outcome = []
        for s, req in ((svc, r), (jsvc, jr)):
            try:
                s.validate(req)
                c = s.plan(req)
                outcome.append(("ok", c.method, c.quant, c.wave_size))
            except (RequestRejected, JRequestRejected) as e:
                outcome.append(("rejected", type(e).__name__,
                                re.sub(r"uid=\d+: ", "", str(e))))
        assert outcome[0] == outcome[1], kw
    # a planned merged-index method becomes nlj on the sharded tenant
    eng = svc.engine("t")
    assert eng.plan_request(20, theta=thetas[0]) == ("nlj", "off")
    svc.submit(JoinRequest(uid=9, tenant="t", X=ds.X[:20], theta=thetas[0],
                           method="nlj", quant="off"))
    done = svc.run()
    assert done[9].ok and len(done[9].pairs) == len(exact_join_pairs(
        ds.X[:20], ds.Y, thetas[0], device=CPU))


# -- engine, configs, launchers ------------------------------------------------------

def test_engine_shard_resolution_and_errors(ds, thetas):
    eng = JoinEngine(ds.Y, device=CPU, n_shards=2, metrics=Metrics())
    assert eng.build_counts["sharded"] == 0
    with pytest.raises(ValueError, match="device"):
        eng.join(ds.X, JoinConfig(method="nlj", theta=thetas[0]))
    with pytest.raises(ValueError, match="device"):
        eng.join(ds.X, JoinConfig(theta=thetas[0]))
    with pytest.raises(NotImplementedError, match="per-device"):
        JoinEngine(ds.Y, n_shards=2, mesh=_mesh(2)).join(
            ds.X, JoinConfig(method="es_sws", theta=thetas[0]))
    auto = JoinEngine(ds.Y, n_shards=0, mesh=_mesh(3), metrics=Metrics())
    assert auto.n_shards == 3 and auto.device == CPU
    one = make_engine(ds.Y, "serving_sq8", device=CPU)
    assert one.n_shards == 1 and one.build_counts["sharded"] == 0
    assert one.carry_window == 16_384 and one.default.quant == "sq8"
    assert {k: v.n_shards for k, v in ENGINE_PRESETS.items()
            if k.startswith("serving")} == {"serving": 0, "serving_sq8": 0,
                                            "serving_sketch8": 0}
    two = make_engine(ds.Y, "ci", mesh=_mesh(2), n_shards=2)
    r = two.join(ds.X[:16], JoinConfig(theta=thetas[1], wave_size=WAVE))
    assert two.build_counts["sharded"] == 1 and len(r.pairs)
    two.warm_quant(ds.X[:16], JoinConfig(theta=thetas[1], quant="sq8"))
    assert two.build_counts["quant"] == 1
    two.drop_caches()
    assert not two._sharded and not two._nlj_steps and not two._plans


def _result_lines(out: str) -> list[str]:
    keep = []
    for ln in out.splitlines():
        if ln.startswith("[join] ") and ("pairs in" in ln
                                         or "recall=" in ln):
            keep.append(re.sub(r" in [0-9.]+s", "", ln))
    return keep


def test_launcher_shards_matches_reference(ref, capsys):
    assert launch.main(["--device", "cpu,cpu", "--shards", "2",
                        *LAUNCH_ARGS]) == 0
    got = capsys.readouterr().out
    assert "shards=2" in got
    lines = _result_lines(got)
    assert len(lines) == 2 and "sound=True" in lines[1]
    assert lines == _result_lines(str(ref["launcher"]))
    with pytest.raises(SystemExit) as e:
        launch.main(["--device", "cpu", "--shards", "3", *LAUNCH_ARGS])
    assert e.value.code == 2
    assert "only 1 device(s) visible" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        launch.main(["--device", "cpu,cpu", "--shards", "2", "--stream",
                     "16", "--method", "es_sws", *LAUNCH_ARGS])
    assert "--stream with --shards" in capsys.readouterr().err


def test_serve_launcher_shards_nlj_only(capsys):
    from repro_torch.launch import serve_join
    argv = ["--device", "cpu,cpu", "--shards", "2", "--n-data", "600",
            "--dim", "16", "--requests", "6", "--max-request", "24",
            "--buckets", "16,32", "--tenants", "1"]
    with pytest.raises(SystemExit):
        serve_join.main(argv)
    assert "--method nlj only" in capsys.readouterr().err
    assert serve_join.main(argv + ["--method", "nlj"]) == 0
    out = capsys.readouterr().out
    assert "sound=True" in out and "6/6" in out


# -- the one-shot API ---------------------------------------------------------------

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


@pytest.mark.parametrize("prebuilt", [False, True])
def test_vector_join_matches_reference(ds_manifold, index_merged, theta_mid,
                                       prebuilt):
    theta = _clear_theta(ds_manifold, theta_mid)
    X, Y = ds_manifold.X[:48], ds_manifold.Y
    kw = {}
    if prebuilt:
        jkw = dict(index_merged=index_merged)
        kw = dict(index_merged=graph_index_from_numpy(
            np.asarray(index_merged.vecs), np.asarray(index_merged.nbrs),
            np.asarray(index_merged.start),
            np.asarray(index_merged.mean_nbr_dist), index_merged.n_data, CPU))
        X = ds_manifold.X            # the merged index holds every query
    else:
        jkw = {}
    bk = dict(k=16, degree=8)
    want = jvector_join(X, Y, JJoinConfig(theta=theta), build_kw=bk, **jkw)
    got = vector_join(X, Y, JoinConfig(theta=theta), build_kw=bk,
                      device=CPU, **kw)
    assert got.pair_set() == want.pair_set() and len(got.pairs)
    assert (got.stats.n_dist, got.stats.n_ood) == (want.stats.n_dist,
                                                   want.stats.n_ood)


def test_run_search_wave_matches_reference(ds_manifold, index_y, theta_mid):
    theta = _clear_theta(ds_manifold, theta_mid)
    tc = dict(beam_width=64, pool_cap=512, seeds_max=4, max_iters=1024)
    piy = graph_index_from_numpy(
        np.asarray(index_y.vecs), np.asarray(index_y.nbrs),
        np.asarray(index_y.start), np.asarray(index_y.mean_nbr_dist),
        index_y.n_data, CPU)
    rng = np.random.default_rng(4)
    qids = np.arange(24, dtype=np.int32)
    lane_valid = np.ones(32, bool)
    lane_valid[24:] = False
    qids = np.concatenate([qids, np.zeros(8, np.int32)])
    seeds = rng.integers(0, 2000, size=(32, 4)).astype(np.int32)
    seeds_valid = rng.random((32, 4)) < 0.6
    seeds_valid[:, 0] = True
    xw = ds_manifold.X[qids]
    st, jst = JoinStats(), JJoinStats()
    want = jrun_search_wave(
        index_y, xw, qids, lane_valid,
        JJoinConfig(method="es", theta=theta,
                    traversal=JTraversalConfig(**tc), wave_size=32), jst,
        seeds=seeds, seeds_valid=seeds_valid)
    got = run_search_wave(
        piy, torch.from_numpy(xw), qids, lane_valid,
        JoinConfig(method="es", theta=theta,
                   traversal=TraversalConfig(**tc), wave_size=32), st,
        seeds=seeds, seeds_valid=seeds_valid)
    assert np.array_equal(got.pairs, np.asarray(want.pairs))
    assert np.array_equal(got.n_pool, np.asarray(want.n_pool))
    assert np.array_equal(got.best_idx, np.asarray(want.best_idx))
    assert (st.n_dist, st.n_iters) == (jst.n_dist, jst.n_iters) \
        and st.n_dist > 0
