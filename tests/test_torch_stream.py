"""The streaming engine of the PyTorch port against the JAX package.

``JoinEngine.submit`` joins one batch under global query ids; for
``es_sws``/``es_hws`` the work-sharing cache and the carry window of
completed queries persist across batches, and each new query seeds from
the cache entry of its nearest carried query (its *parent*). Both engines
traverse the reference's own G_Y, carried across with
``graph_index_from_numpy`` and ``adopt``. On it, over three batches:

  * pairs (global ids), ``n_dist``, ``n_iters`` and the cache counters
    (``cache_evictions`` and ``cache_tombstones`` included) equal the JAX
    engine's, and so do the carried state (``_stream_cache``'s entries,
    ``_stream_entry_n``, ``_carry_qids``), with the wave pipeline's overlap
    on and off and a carry window of 4096 and of 16 (smaller than a wave:
    donors leave the window before their cache entry lands, the tombstone
    path);
  * under sq8 the same, on the reference's int8 store over G_Y carried
    across, against the reference run with overlap off (with overlap on
    the reference drops band entries after a cap retry; ROADMAP Queue C).
    The parents come from the int8 pairwise d̂
    (``ops.pairwise_sq_dists_int8``), whose plain version may round a
    group sum apart from the reference's in the last bit: a parent that
    differs must be a near-tie, its d̂ in float64 within 1e-6 (relative)
    of the reference parent's. Such near-ties are counted; on these inputs
    there are none, and the test demands so, for a different parent
    would change the seeds and so the counters;
  * the cost table each stream feeds holds the reference's key, and its
    entry carries the meters (``n_dist``, ``n_rerank``,
    ``bytes_assembly``) of the batch it calibrated from, the reference's
    for that batch; the wall clock picks that batch, so it may differ
    between the engines;
  * the LSH estimator (``sketch_survivors`` masks, every ``BandEstimate``
    field) and the band cap it seeds (``estimate_rerank_cap``, sq8 and
    sketch8) equal the reference's exactly;
  * an nlj batch equals the exact NLJ of its queries shifted by the
    offset; a merged-index batch equals ``join`` of its queries shifted by
    the offset, and the reference's ``submit``;
  * ``submit_many`` equals sequential ``submit`` calls; ``reset_stream``
    clears every piece of carried state;
  * ``launch.join --stream`` and ``--sweep`` print the JAX launcher's pair
    counts and ``n_dist``.

θ is moved to the middle of its gap when a pair lies within 1e-6
(relative) of θ² in float64, so f32 rounding cannot decide a pair
differently in the two packages.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

from repro.core import JoinConfig as JJoinConfig
from repro.core import TraversalConfig as JTraversalConfig
from repro.core import build_index as jbuild_index
from repro.core import build_merged_index as jbuild_merged_index
from repro.data.vectors import make_dataset, thresholds
from repro.engine import JoinEngine as JJoinEngine
from repro.launch import join as jlaunch
from repro.plan import LshEstimator as JLshEstimator
from repro.quant import sketch as jsketch
from repro_torch.core import JoinConfig, TraversalConfig, exact_join_pairs
from repro_torch.core.types import graph_index_from_numpy, pair_keys
from repro_torch.engine import JoinEngine
from repro_torch.launch import join as launch
from repro_torch.obs.metrics import Metrics
from repro_torch.plan import LshEstimator
from repro_torch.quant import QuantStore, dequantize, quantize_queries
from repro_torch.quant import sketch as psketch

CPU = torch.device("cpu")
BK = dict(k=24, degree=12)
BATCH = 40         # three batches of 120 queries, the last one 40
WAVE = 32          # two waves a batch, the second one padded
TC = dict(beam_width=64, expand_per_iter=4, pool_cap=1024, hybrid_beam=64,
          seeds_max=8, max_iters=2048)
STAT_FIELDS = ("n_dist", "n_iters", "n_overflow", "cache_hits",
               "cache_misses", "cache_evictions", "cache_tombstones",
               "peak_cache_entries")
SQ8_FIELDS = STAT_FIELDS + ("n_rerank", "overflow_retries",
                            "n_rerank_gather", "quant_bytes")


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


def _port_store(jstore) -> QuantStore:
    return QuantStore(q=torch.tensor(np.asarray(jstore.q)),
                      scales=torch.tensor(np.asarray(jstore.scales)),
                      norms=torch.tensor(np.asarray(jstore.norms)),
                      err=torch.tensor(np.asarray(jstore.err)),
                      group_size=int(jstore.group_size))


@pytest.fixture(scope="module")
def ds():
    return make_dataset("manifold", n_data=1501, n_query=120, dim=40,
                        seed=42)


@pytest.fixture(scope="module")
def theta(ds):
    return _clear_theta(ds, float(thresholds(ds, 3)[1]))


@pytest.fixture(scope="module")
def jiy(ds):
    return jbuild_index(ds.Y, **BK)


@pytest.fixture(scope="module")
def piy(jiy):
    return _port_index(jiy)


def _batches(ds):
    return [ds.X[b0:b0 + BATCH] for b0 in range(0, ds.X.shape[0], BATCH)]


def _cfgs(method, theta, quant="off", overlap=True):
    kw = dict(method=method, theta=theta, wave_size=WAVE, quant=quant,
              overlap=overlap)
    return (JJoinConfig(traversal=JTraversalConfig(**TC), **kw),
            JoinConfig(traversal=TraversalConfig(**TC), **kw))


def _record_parents(eng) -> list:
    """Wrap the engine's parent choice to log each wave's parents."""
    log = []
    choose = eng._assign_parents

    def recorded(*a, **kw):
        p = choose(*a, **kw)
        log.append(p)
        return p
    eng._assign_parents = recorded
    return log


def _state(eng) -> tuple:
    return (eng.n_submitted, eng._stream_entry_n,
            np.asarray(eng._carry_qids).tolist(),
            {int(k): np.asarray(v).tolist()
             for k, v in eng._stream_cache.items()})


def _assert_cost_table(eng, got, jtable, want, sizes):
    """One (method, quant) stream's cost table: the reference's key, and
    an entry made from the first batch with the fewest seconds per query
    (``CostTable.observe``'s rule, the same in both engines) whose meters
    equal the reference's for that batch; ``plan.calibrations`` (in the
    engine's own registry) counts each batch that set a new low."""
    (jentry,) = jtable.entries()
    (entry,) = eng.cost_table.entries()
    assert (entry.method, entry.quant) == (jentry.method, jentry.quant)
    for table_entry, res in ((entry, got), (jentry, want)):
        per_q = [r.stats.total_seconds / n for r, n in zip(res, sizes)]
        i = int(np.argmin(per_q))
        assert (table_entry.n_queries, table_entry.seconds) == (
            sizes[i], res[i].stats.total_seconds)
        assert (table_entry.n_dist, table_entry.n_rerank,
                table_entry.bytes_assembly) == (
            want[i].stats.n_dist, want[i].stats.n_rerank,
            want[i].stats.bytes_assembly)
    per_q = [r.stats.total_seconds / n for r, n in zip(got, sizes)]
    lows = sum(p < min(per_q[:k], default=np.inf)
               for k, p in enumerate(per_q))
    assert eng.metrics.value("plan.calibrations") == lows


def _assert_results(got, want, n_data, fields):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.pairs.dtype == np.int64
        np.testing.assert_array_equal(pair_keys(g.pairs, n_data),
                                      pair_keys(w.pairs, n_data))
        for f in fields:
            assert getattr(g.stats, f) == getattr(w.stats, f), f


@pytest.fixture(scope="module")
def ref_runs():
    return {}


def _reference_stream(runs, ds, jiy, theta, method, quant, carry_window):
    """The JAX engine's stream (overlap on in f32, off under sq8), with
    its parents per wave, its int8 store over G_Y and its final state;
    memoized in ``runs`` per case."""
    key = (method, quant, carry_window)
    if key not in runs:
        jcfg = _cfgs(method, theta, quant, overlap=quant == "off")[0]
        eng = JJoinEngine(ds.Y, build_kw=BK, carry_window=carry_window)
        eng.adopt(index_y=jiy)
        parents = _record_parents(eng)
        res = [eng.submit(X, jcfg) for X in _batches(ds)]
        store = (eng._tier_stores[("int8", "index_y")]
                 if quant != "off" else None)
        runs[key] = (res, parents, store, _state(eng), eng.cost_table)
    return runs[key]


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("carry_window", [4096, 16])
@pytest.mark.parametrize("method", ["es_sws", "es_hws"])
def test_stream_identical_to_jax(ds, jiy, piy, theta, ref_runs, method,
                                 carry_window, overlap):
    want, jparents, _, jstate, jtable = _reference_stream(
        ref_runs, ds, jiy, theta, method, "off", carry_window)
    cfg = _cfgs(method, theta, overlap=overlap)[1]
    eng = JoinEngine(ds.Y, build_kw=BK, carry_window=carry_window,
                     device=CPU, metrics=Metrics())
    eng.adopt(index_y=piy)
    parents = _record_parents(eng)
    got = [eng.submit(X, cfg) for X in _batches(ds)]
    assert eng.n_index_builds == 0                  # the adopted G_Y
    assert parents == jparents                      # the f32 host argmin
    _assert_results(got, want, ds.Y.shape[0], STAT_FIELDS)
    assert _state(eng) == jstate
    _assert_cost_table(eng, got, jtable, want,
                       [len(X) for X in _batches(ds)])
    assert sum(r.stats.cache_hits for r in got) > 0
    if carry_window < WAVE:
        assert sum(r.stats.cache_tombstones for r in got) > 0
    assert eng.serve_stats["batches"] == len(got)


def _near_ties(ds, store, parents, jparents) -> int:
    """Waves' parents that differ from the reference's: each must be a
    near-tie (the two donors' quantized-domain d̂ to the query within 1e-6,
    relative, in float64). Returns their count."""
    qx = quantize_queries(torch.from_numpy(ds.X), store)[0]
    x64 = dequantize(qx, store.scales, store.group_size).double().numpy()
    ties = 0
    for got, want in zip(parents, jparents):
        assert got.keys() == want.keys()
        for q, p in got.items():
            if p == want[q]:
                continue
            a, b = (((x64[q] - x64[r]) ** 2).sum() for r in (p, want[q]))
            assert abs(a - b) <= 1e-6 * max(a, b), (q, p, want[q], a, b)
            ties += 1
    return ties


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("carry_window", [4096, 16])
@pytest.mark.parametrize("method", ["es_sws", "es_hws"])
def test_sq8_stream_identical_to_jax(ds, jiy, piy, theta, ref_runs, method,
                                     carry_window, overlap):
    want, jparents, jstore, jstate, jtable = _reference_stream(
        ref_runs, ds, jiy, theta, method, "sq8", carry_window)
    cfg = _cfgs(method, theta, "sq8", overlap)[1]
    eng = JoinEngine(ds.Y, build_kw=BK, carry_window=carry_window,
                     device=CPU, metrics=Metrics())
    eng.adopt(index_y=piy)
    store = _port_store(jstore)
    eng._tier_stores.put(("int8", "index_y"), store)
    parents = _record_parents(eng)
    got = [eng.submit(X, cfg) for X in _batches(ds)]
    assert eng.n_index_builds == 0                  # G_Y and its store
    assert eng._carry_codes is not None and eng._carry_vecs is None
    ties = _near_ties(ds, store, parents, jparents)
    assert ties == 0
    _assert_results(got, want, ds.Y.shape[0], SQ8_FIELDS)
    assert _state(eng) == jstate
    _assert_cost_table(eng, got, jtable, want,
                       [len(X) for X in _batches(ds)])
    assert sum(r.stats.n_rerank for r in got) > 0


@pytest.mark.parametrize("sample_y", [None, 512])
def test_estimator_matches_jax(ds, theta, sample_y):
    """Two estimates (the first call's query draw differs from later
    ones', as in the reference) at the full sample and at a sampled
    quarter of Y: every field and the survivor masks equal."""
    jest = JLshEstimator(ds.Y, sample_y=sample_y)
    pest = LshEstimator(torch.from_numpy(ds.Y), sample_y=sample_y)
    for X, th in ((ds.X, theta), (ds.X[:40], 1.2 * theta)):
        want, got = jest.estimate(X, th), pest.estimate(X, th)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.rerank_cap(1024) == want.rerank_cap(1024)
    np.testing.assert_array_equal(pest._rows, np.asarray(jest._rows))
    np.testing.assert_array_equal(
        psketch.sketch_survivors(ds.X, pest._store, theta),
        np.asarray(jsketch.sketch_survivors(ds.X, jest._store, theta)))


def test_estimated_rerank_caps_match_jax(ds, theta):
    jeng = JJoinEngine(ds.Y)
    peng = JoinEngine(ds.Y, device=CPU)
    for quant in ("sq8", "sketch8"):
        jcfg, cfg = _cfgs("es_sws", theta, quant)
        cap = peng.estimate_rerank_cap(ds.X[:BATCH], cfg)
        assert cap == jeng.estimate_rerank_cap(ds.X[:BATCH], jcfg)
        assert 16 <= cap <= 1024
    assert peng.estimate_rerank_cap(ds.X, _cfgs("es", theta)[1]) is None


def test_nlj_batch_is_exact_for_its_id_range(ds, piy, theta):
    eng = JoinEngine(ds.Y, build_kw=BK, device=CPU)
    eng.adopt(index_y=piy)
    X0, X1 = _batches(ds)[:2]
    eng.submit(X0, _cfgs("es", theta)[1])
    got = eng.submit(X1, _cfgs("nlj", theta)[1])
    want = exact_join_pairs(X1, torch.from_numpy(ds.Y), theta)
    want[:, 0] += BATCH
    np.testing.assert_array_equal(got.pairs, want)
    assert got.stats.n_dist == BATCH * ds.Y.shape[0]
    assert eng.n_submitted == 2 * BATCH


@pytest.mark.parametrize("quant", ["off", "sq8"])
def test_mi_batch_is_its_join_shifted_and_the_references(ds, theta, quant):
    """An es_mi_adapt batch after a first batch: its merged index (the
    reference's, carried across) serves both ``submit`` and ``join``;
    under sq8 the submit's band cap is seeded from the LSH estimate and
    ``join``'s is not, which may change the retries, never the pairs. The
    reference runs with overlap off under sq8."""
    X0, X1 = _batches(ds)[:2]
    jcfg, cfg = _cfgs("es_mi_adapt", theta, quant,
                      overlap=quant == "off")
    jm = [jbuild_merged_index(ds.Y, X, **BK) for X in (X0, X1)]
    jeng = JJoinEngine(ds.Y, build_kw=BK)
    eng = JoinEngine(ds.Y, build_kw=BK, device=CPU)
    for X, m in zip((X0, X1), jm):
        jeng.adopt(X=X, index_merged=m)
        eng.adopt(X=X, index_merged=_port_index(m))
    want = [jeng.submit(X, jcfg) for X in (X0, X1)]
    got = [eng.submit(X, cfg) for X in (X0, X1)]
    fields = ("n_dist", "n_iters", "n_ood") + (
        ("n_rerank", "overflow_retries") if quant != "off" else ())
    _assert_results(got, want, ds.Y.shape[0], fields)
    alone = eng.join(X1, cfg)
    shifted = alone.pairs.copy()
    shifted[:, 0] += BATCH
    np.testing.assert_array_equal(pair_keys(got[1].pairs, ds.Y.shape[0]),
                                  pair_keys(shifted, ds.Y.shape[0]))
    assert got[1].stats.n_dist == alone.stats.n_dist
    assert eng.build_counts["merged"] == 0          # the adopted indexes


@pytest.mark.parametrize("quant", ["off", "sq8"])
def test_submit_many_equals_submit(ds, piy, theta, quant):
    """A mixed job list (two es_sws batches pipelined as one group, an nlj
    batch, another es_sws batch) against the same jobs through
    ``submit``: pairs, counters and the carried state equal."""
    cfg = _cfgs("es_sws", theta, quant)[1]
    nlj = _cfgs("nlj", theta, quant)[1]
    X0, X1, X2 = _batches(ds)
    jobs = [(X0, cfg), (X1, cfg), (X2[:20], nlj), (X2[20:], cfg)]
    fields = STAT_FIELDS + (("n_rerank",) if quant != "off" else ())
    eng = JoinEngine(ds.Y, build_kw=BK, carry_window=48, device=CPU)
    eng.adopt(index_y=piy)
    seq = [eng.submit(X, c) for X, c in jobs]
    state = _state(eng)
    eng.reset_stream()
    many = eng.submit_many(jobs)
    _assert_results(many, seq, ds.Y.shape[0], fields)
    assert _state(eng) == state
    assert eng.serve_stats["batches"] == 2 * len(jobs)


def test_reset_stream_clears_the_carry(ds, piy, theta):
    eng = JoinEngine(ds.Y, build_kw=BK, device=CPU)
    eng.adopt(index_y=piy)
    cfg = _cfgs("es_sws", theta, "sq8")[1]
    first = [eng.submit(X, cfg) for X in _batches(ds)]
    assert eng.n_submitted == ds.X.shape[0] and eng._stream_cache
    eng.reset_stream()
    assert _state(eng) == (0, 0, [], {})
    assert (eng._carry_vecs, eng._carry_codes, eng._carry_norms) == (
        None, None, None)
    again = [eng.submit(X, cfg) for X in _batches(ds)]
    _assert_results(again, first, ds.Y.shape[0], STAT_FIELDS)


def _launch_lines(out: str) -> list[str]:
    return [re.sub(r" in [0-9.]+s", "", ln) for ln in out.splitlines()
            if ln.startswith(("[sweep]", "[join] 3 streamed"))]


@pytest.mark.parametrize("extra", [["--stream", "64", "--method", "es_sws"],
                                   ["--sweep", "--quant", "sq8"]])
def test_launcher_stream_and_sweep_match_jax(capsys, extra):
    argv = ["--n-data", "1200", "--n-query", "160", "--dim", "16",
            "--engine-spec", "ci", "--theta-q", "3", *extra]
    assert launch.main(["--device", "cpu", *argv]) == 0
    got = capsys.readouterr().out
    assert jlaunch.main(argv) == 0
    want = capsys.readouterr().out
    assert _launch_lines(got) == _launch_lines(want)
    assert len(_launch_lines(got)) == (1 if "--stream" in extra else 7)
    assert "sound=True" in got
