"""The 1-bit sketch tier of the PyTorch port against the JAX package.

On the same numpy inputs: the Hamming ops (the port's plain versions,
what its dispatcher runs for CPU tensors) against ``repro.kernels.ops``
at ``impl="ref"`` and ``"pallas_interpret"``, exactly; the SketchStore
(rotation, isometry factor and checkpoint grid equal; codes equal but for
counted sign bits of coordinates within f32 rounding of 0; slack tables
within 1e-5 relative); the certified lower bounds against float64
distances; and the sketch8 joins — ``es_mi`` / ``es_mi_adapt`` on the
reference's merged index with the reference's stores carried across,
against the JAX engine with overlap off (the reference drops band
entries after a cap retry with overlap on, see ``test_torch_sq8.py``):
identical pairs, ``n_dist``, ``n_iters``, ``n_esc8``, ``n_rerank`` and
``overflow_retries``; the sketch8 NLJ against the JAX NLJ and the f32
truth, counts equal; and the launcher. The CUDA kernels themselves run
only on the card (``tests/test_torch_cuda.py``).

Sketch codes are int32 words holding the reference's uint32 bits; they
are compared through ``.view(np.uint32)``.
"""
import dataclasses
import math
import re
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import JoinConfig as JJoinConfig
from repro.core import TraversalConfig as JTraversalConfig
from repro.core import exact_join_pairs as jexact
from repro.core.join import cascade_join_pairs as jcascade_join
from repro.data.vectors import thresholds
from repro.engine import JoinEngine as JJoinEngine
from repro.kernels import ops as jops
from repro.launch import join as jlaunch
from repro.quant import cascade as jcascade
from repro.quant import sketch as jsketch
from repro_torch.core import JoinConfig, TraversalConfig
from repro_torch.core.join import cascade_join_pairs
from repro_torch.core.types import graph_index_from_numpy, pair_keys
from repro_torch.engine import JoinEngine
from repro_torch.kernels import ops, ref
from repro_torch.launch import join as launch
from repro_torch.quant import cascade, sketch
from repro_torch.quant.store import QuantStore

JAX_IMPLS = ("ref", "pallas_interpret")
CPU = torch.device("cpu")
WAVE = 48
CAP = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the port's CPU tests run many small ops, and
    with the suite's parallel workers on every core, thread-pool regions
    waiting for descheduled threads slow them tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _words(rng, *shape) -> np.ndarray:
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


# -- Hamming ops ---------------------------------------------------------------

@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("B,N,W", [(1, 1, 1), (3, 5, 2), (9, 130, 4),
                                   (0, 4, 4), (4, 0, 2)])
def test_pairwise_hamming_matches_jax(B, N, W, impl):
    rng = _rng("pw", B, N, W)
    cx, cy = _words(rng, B, W), _words(rng, N, W)
    got = ops.pairwise_hamming(torch.from_numpy(cx.view(np.int32)),
                               torch.from_numpy(cy.view(np.int32)))
    want = np.asarray(jops.pairwise_hamming(jnp.asarray(cx), jnp.asarray(cy),
                                            impl=impl))
    assert got.dtype == torch.int32 and got.shape == (B, N)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("B,K,W", [(1, 1, 1), (3, 5, 2), (9, 33, 4),
                                   (0, 4, 4), (3, 0, 2)])
def test_rowwise_and_gather_hamming_match_jax(B, K, W, impl):
    rng = _rng("rw", B, K, W)
    codes, cx = _words(rng, 40, W), _words(rng, B, W)
    idx = rng.integers(0, 40, (B, K)).astype(np.int32)
    idx[rng.random((B, K)) < 0.4] = -1
    cands = codes[np.maximum(idx, 0)]
    want = np.asarray(jops.rowwise_hamming(jnp.asarray(cx),
                                           jnp.asarray(cands), impl=impl))
    t = {k: torch.from_numpy(v.view(np.int32))
         for k, v in (("codes", codes), ("cx", cx), ("cands", cands))}
    got = ops.rowwise_hamming(t["cx"], t["cands"])
    np.testing.assert_array_equal(got.numpy(), want)
    # the gather form the traversal uses: rows by id, NO_NODE → -1
    g = ops.gather_hamming(t["codes"], t["cx"], torch.from_numpy(idx))
    np.testing.assert_array_equal(g.numpy(), np.where(idx >= 0, want, -1))


# -- the store -----------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(300, 40), (200, 128), (50, 33)])
def test_sketch_store_matches_jax(n, d):
    v = _rng("v", n, d).normal(size=(n, d)).astype(np.float32) * 2 + 0.5
    rows = np.arange(n) % 4 != 0
    st = sketch.build_sketch(torch.from_numpy(v), scale_rows=rows)
    jst = jsketch.build_sketch(v, scale_rows=rows)
    R, iso = sketch.make_rotation(d)
    jR, jiso = jsketch.make_rotation(d)
    np.testing.assert_array_equal(R, jR)
    assert iso == jiso and float(st.iso) == float(jst.iso)
    np.testing.assert_array_equal(st.hs.numpy(), np.asarray(jst.hs))
    np.testing.assert_array_equal(st.mu.numpy(), np.asarray(jst.mu))
    assert st.nbytes == jst.nbytes
    # codes: equal but for sign bits of coordinates within f32 rounding
    # of 0 (the two packages' f32 matrix products round apart)
    got = st.codes.numpy().view(np.uint32)
    want = np.asarray(jst.codes)
    z = (v.astype(np.float64) - np.asarray(jst.mu, np.float64)) @ \
        jR.astype(np.float64).T
    bits = np.unpackbits(
        (got ^ want).view(np.uint8), axis=1, bitorder="little")[:, :d]
    r, c = np.nonzero(bits)
    assert r.size <= max(2, n * d // 10000)
    scale = np.linalg.norm(z, axis=1)
    assert np.all(np.abs(z[r, c]) <= 1e-5 * scale[r])
    np.testing.assert_allclose(st.cum.numpy(), np.asarray(jst.cum),
                               rtol=1e-5, atol=1e-5 * float(np.abs(
                                   np.asarray(jst.cum)).max()))
    # queries on the store's grid
    x = _rng("x", d).normal(size=(7, d)).astype(np.float32) * 2
    qc, qcum = sketch.sketch_queries(torch.from_numpy(x), st)
    jqc, jqcum = jsketch.sketch_queries(x, jst)
    assert (qc.numpy().view(np.uint32) != np.asarray(jqc)).sum() <= 2
    np.testing.assert_allclose(qcum.numpy(), np.asarray(jqcum), rtol=1e-5,
                               atol=1e-4)


def _carry_sketch(jst) -> sketch.SketchStore:
    return sketch.sketch_store_from_numpy(
        *(np.asarray(getattr(jst, f))
          for f in ("codes", "cum", "hs", "mu", "rot", "iso")), device=CPU)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("d", [24, 64, 130])
def test_sketch_lower_bounds_are_certified(seed, d):
    """Every form of the bound stays ≤ the float64 squared distance, and
    equals the reference's bound on the same store (rtol 1e-6)."""
    rng = _rng("lb", seed, d)
    shift = rng.normal(size=d) * 3
    v = (rng.normal(size=(120, d)) * rng.uniform(0.2, 3, d)
         + shift).astype(np.float32)
    x = (v[:20] + rng.normal(size=(20, d)) * 0.3).astype(np.float32)
    jst = jsketch.build_sketch(v)
    st = _carry_sketch(jst)
    jqc, jqcum = jsketch.sketch_queries(x, jst)
    qc = torch.tensor(np.asarray(jqc).view(np.int32))
    qcum = torch.tensor(np.asarray(jqcum))
    d64 = ((x.astype(np.float64)[:, None] - v.astype(np.float64)[None])
           ** 2).sum(-1)
    h = ops.pairwise_hamming(qc, st.codes)
    lb = sketch.sketch_lower_bound_pairwise(h, qcum, st.cum, st.hs, st.iso)
    assert np.all(lb.double().numpy() <= d64)
    jlb = jsketch.sketch_lower_bound_pairwise(
        jnp.asarray(h.numpy()), jqcum, jst.cum, jst.hs, jst.iso)
    np.testing.assert_allclose(lb.numpy(), np.asarray(jlb), rtol=1e-6,
                               atol=1e-6 * float(d64.max()))
    idx = rng.integers(0, 120, (20, 17)).astype(np.int32)
    idx[:, :3] = -1
    t_idx = torch.from_numpy(idx)
    hg = ops.gather_hamming(st.codes, qc, t_idx)
    glb, gnc = sketch.sketch_lower_bound_gather(hg, qcum, st.cum, t_idx,
                                                st.hs, st.iso)
    rows = np.take_along_axis(d64, np.maximum(idx, 0), axis=1)
    assert np.all(np.isinf(glb.numpy()[idx < 0]))
    assert np.all(glb.double().numpy()[idx >= 0] <= rows[idx >= 0])
    rlb = sketch.sketch_lower_bound_rowwise(
        hg.clamp_min(0), qcum, st.cum[t_idx.clamp_min(0).long()], st.hs,
        st.iso)
    np.testing.assert_array_equal(glb.numpy()[idx >= 0],
                                  rlb.numpy()[idx >= 0])
    np.testing.assert_array_equal(gnc.numpy()[idx >= 0],
                                  st.cum.numpy()[idx, -1][idx >= 0])


def test_sketch_tier_matches_jax_on_a_carried_store():
    """``SketchTier.gather_bounds`` (lb and navigation estimate) and
    ``pair_refine`` against the reference's tier on the same store."""
    rng = _rng("tier")
    v = rng.normal(size=(200, 48)).astype(np.float32)
    x = rng.normal(size=(9, 48)).astype(np.float32)
    jtier = jcascade.SketchTier(jsketch.build_sketch(v))
    tier = cascade.SketchTier(_carry_sketch(jtier.store))
    jq = jtier.encode(x)
    q = cascade.SketchQueries(
        codes=torch.tensor(np.asarray(jq.codes).view(np.int32)),
        cum=torch.tensor(np.asarray(jq.cum)))
    cand = rng.integers(0, 200, (9, 30)).astype(np.int32)
    jlb, _, jest = jtier.gather_bounds(jq, jnp.asarray(cand), impl="ref")
    cand[:, :4] = -1
    lb, ub, est = tier.gather_bounds(q, torch.from_numpy(cand), impl=None)
    assert ub is None
    ok = cand >= 0
    # lb₂ = n_q + n_c − 2√(…) cancels: one ulp of an input moves it by
    # ~1e-7·(n_q + n_c)
    energy = (q.cum[:, -1:].numpy()
              + tier.store.cum.numpy()[np.maximum(cand, 0), -1])
    assert np.all(np.abs(lb.numpy() - np.asarray(jlb))[ok]
                  <= 1e-6 * np.abs(np.asarray(jlb))[ok] + 1e-6 * energy[ok])
    np.testing.assert_allclose(est.numpy()[ok], np.asarray(jest)[ok],
                               rtol=1e-5, atol=1e-4)
    assert np.all(np.isinf(lb.numpy()[~ok])) and np.all(
        np.isinf(est.numpy()[~ok]))
    qi = rng.integers(0, 9, 50)
    yi = rng.integers(0, 200, 50)
    plb, pub = tier.pair_refine(q, torch.from_numpy(qi), torch.from_numpy(yi))
    jplb, _ = jtier.pair_refine(jq, jnp.asarray(qi), jnp.asarray(yi))
    assert pub is None
    pe = q.cum.numpy()[qi, -1] + tier.store.cum.numpy()[yi, -1]
    assert np.all(np.abs(plb.numpy() - np.asarray(jplb))
                  <= 1e-6 * np.abs(np.asarray(jplb)) + 1e-6 * pe)


def _flip_bits(words: np.ndarray, m: int) -> np.ndarray:
    """A uint32 code row with its first ``m`` bits flipped: Hamming count
    ``m`` from the original."""
    out = words.copy()
    for i in range(m):
        out[i // 32] ^= np.uint32(1 << (i % 32))
    return out


@pytest.mark.parametrize("iso", [None, 0.75])
@pytest.mark.parametrize("d", [40, 128, 150])
def test_gather_sketch_bounds_match_jax_on_a_carried_store(d, iso):
    """``ref.gather_sketch_bounds`` (the plain version of the fused sketch
    bounds kernel, what ``SketchTier.gather_bounds`` runs on the CPU)
    against the reference tier on the same store, with the tolerance of
    ``test_sketch_tier_matches_jax_on_a_carried_store``: Hamming counts at
    every checkpoint (0 and d among them), NO_NODE and ids ≥ N, d = 40 and
    150 (W not a multiple of 4), the store's iso and iso = 0.75; and bit
    for bit the eager composition it replaced."""
    rng = _rng("gsb", d, iso)
    n, B, K = 150, 7, 40
    v = (rng.normal(size=(n, d)) * rng.uniform(0.2, 3, d)).astype(np.float32)
    x = (v[:B] + rng.normal(size=(B, d)) * 0.5).astype(np.float32)
    jst = jsketch.build_sketch(v)
    jtier = jcascade.SketchTier(jst)
    jq = jtier.encode(x)
    # store rows 0..len(hs)-1 lie exactly hs[k] bits from query 0
    hs = np.asarray(jst.hs)
    codes = np.asarray(jst.codes).copy()
    for r, m in enumerate(hs):
        codes[r] = _flip_bits(np.asarray(jq.codes)[0], int(m))
    jst = dataclasses.replace(jst, codes=jnp.asarray(codes), **(
        {} if iso is None else {"iso": jnp.float32(iso)}))
    jtier = jcascade.SketchTier(jst)
    st = _carry_sketch(jst)
    qc = torch.tensor(np.asarray(jq.codes).view(np.int32))
    qcum = torch.tensor(np.asarray(jq.cum))
    idx = rng.integers(0, n, (B, K)).astype(np.int32)
    idx[0, :len(hs)] = np.arange(len(hs))
    idx[1:, :3] = -1                                    # NO_NODE
    idx[1:, 3] = n + 5                                  # past the table
    ok = (idx >= 0) & (idx < n)
    t_idx = torch.from_numpy(idx)
    h = ops.gather_hamming(st.codes, qc, t_idx)
    np.testing.assert_array_equal(h[0, :len(hs)].numpy(), hs)
    lb, est = ref.gather_sketch_bounds(st.codes, qc, t_idx, qcum, st.cum,
                                       st.hs, st.iso, dim=d)
    jlb, _, jest = jtier.gather_bounds(jq, jnp.asarray(np.where(ok, idx, 0)),
                                       impl="ref")
    jlb, jest = np.asarray(jlb), np.asarray(jest)
    energy = qcum[:, -1:].numpy() + st.cum.numpy()[np.where(ok, idx, 0), -1]
    assert np.all(np.abs(lb.numpy() - jlb)[ok]
                  <= 1e-6 * np.abs(jlb)[ok] + 1e-6 * energy[ok])
    np.testing.assert_allclose(est.numpy()[ok], jest[ok], rtol=1e-5,
                               atol=1e-4)
    assert np.all(np.isinf(lb.numpy()[~ok])) and np.all(
        np.isinf(est.numpy()[~ok]))
    # the tier on the CPU, and the composition it ran before the fused
    # kernel, bit for bit
    tlb, tub, test = cascade.SketchTier(st).gather_bounds(
        cascade.SketchQueries(codes=qc, cum=qcum), t_idx, impl=None)
    assert tub is None and torch.equal(tlb, lb) and torch.equal(test, est)
    olb, nc = sketch.sketch_lower_bound_gather(h, qcum, st.cum, t_idx, st.hs,
                                               st.iso, dim=d)
    nq = qcum[:, -1][:, None]
    cos = torch.cos(math.pi * h.float() / d)
    oest = nq + nc - 2.0 * torch.sqrt(torch.clamp_min(nq * nc, 0.0)) * cos
    oest = torch.where(torch.isfinite(olb), oest, math.inf)
    assert torch.equal(lb, olb) and torch.equal(est, oest)


@pytest.mark.parametrize("B,K", [(0, 5), (3, 0)])
def test_gather_sketch_bounds_of_empty_inputs(B, K):
    """Empty id matrices give empty (lb, est) of their shape."""
    st = sketch.build_sketch(torch.zeros((4, 40)))
    qc, qcum = sketch.sketch_queries(torch.zeros((B, 40)), st)
    lb, est = ops.gather_sketch_bounds(
        st.codes, qc, torch.zeros((B, K), dtype=torch.int32), qcum, st.cum,
        st.hs, st.iso, dim=40)
    assert lb.shape == est.shape == (B, K)
    assert lb.dtype == est.dtype == torch.float32


# -- the sketch8 joins -------------------------------------------------------------

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


def carried_stores(mode: str, vecs) -> dict:
    """The reference's tier stores of ``mode`` over ``vecs``, as the port's."""
    out = {}
    for name in jcascade.TIERS_BY_MODE[mode]:
        st = jcascade.build_tier_store(name, vecs)
        if name == "sketch1":
            out[name] = _carry_sketch(st)
        elif name == "int8":
            out[name] = QuantStore(*(torch.tensor(np.asarray(getattr(st, f)))
                                     for f in ("q", "scales", "norms",
                                               "err")), st.group_size)
        else:
            from repro_torch.quant.pdx import pdx_store_from_numpy
            out[name] = pdx_store_from_numpy(
                *(np.asarray(getattr(st, f)) for f in (
                    "perm", "vp", "ftail", "q", "scales", "qslab", "qtail",
                    "norms", "err")), st.slab, st.dim, device=CPU)
    return out


@pytest.fixture(scope="module")
def case(ds_manifold, index_merged):
    return ds_manifold, index_merged, _clear_theta(
        ds_manifold, float(thresholds(ds_manifold, 3)[1]))


def port_index(jidx):
    return graph_index_from_numpy(
        np.asarray(jidx.vecs), np.asarray(jidx.nbrs), np.asarray(jidx.start),
        np.asarray(jidx.mean_nbr_dist), jidx.n_data, CPU)


@pytest.mark.parametrize("method", ["es_mi", "es_mi_adapt"])
def test_sketch8_mi_join_identical_to_jax(case, method):
    ds, jidx, theta = case
    jcfg = JJoinConfig(method=method, theta=theta, wave_size=WAVE,
                       quant="sketch8", overlap=False,
                       traversal=JTraversalConfig(rerank_cap=CAP))
    want = JJoinEngine(ds.Y, default=jcfg).join(ds.X, index_merged=jidx)
    cfg = JoinConfig(method=method, theta=theta, wave_size=WAVE,
                     quant="sketch8", traversal=TraversalConfig(rerank_cap=CAP))
    eng = JoinEngine(ds.Y, default=cfg, device=CPU)
    eng.adopt(X=ds.X, index_merged=port_index(jidx),
              tier_stores=carried_stores("sketch8", np.asarray(jidx.vecs)))
    got = eng.join(ds.X)
    assert eng.build_counts == {"index_y": 0, "index_x": 0, "merged": 0,
                                "sharded": 0, "quant": 0, "sketch": 0,
                                "pdx": 0}
    n = ds.Y.shape[0]
    np.testing.assert_array_equal(pair_keys(got.pairs, n),
                                  pair_keys(want.pairs, n))
    for f in ("n_dist", "n_iters", "n_esc8", "n_rerank", "n_ood",
              "n_overflow", "quant_bytes"):
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    assert got.stats.n_esc8 > 0
    assert got.stats.overflow_retries >= want.stats.overflow_retries > 0


def test_sketch8_nlj_equals_jax_and_the_f32_truth(case):
    ds, _, theta = case
    jc = jcascade.build_cascade(ds.Y, "sketch8")
    want, jcounts = jcascade_join(ds.X, ds.Y, theta, jc)
    casc = cascade.make_cascade(list(carried_stores("sketch8", ds.Y).items()))
    got, counts = cascade_join_pairs(ds.X, torch.from_numpy(ds.Y), theta,
                                     casc)
    n = ds.Y.shape[0]
    truth = pair_keys(jexact(ds.X, ds.Y, theta), n)
    np.testing.assert_array_equal(pair_keys(got, n), pair_keys(want, n))
    np.testing.assert_array_equal(pair_keys(got, n), truth)
    assert counts == jcounts
    assert 0 < counts["escalated"][0] < ds.X.shape[0] * n
    # the engine's NLJ under sketch8 (its own stores)
    res = JoinEngine(ds.Y, device=CPU).join(
        ds.X, JoinConfig(method="nlj", theta=theta, quant="sketch8"))
    np.testing.assert_array_equal(pair_keys(res.pairs, n), truth)
    assert res.stats.n_esc8 > 0 and res.stats.n_rerank > 0


def _launch_line(out: str) -> str:
    line = next(ln for ln in out.splitlines() if " pairs in " in ln)
    return re.sub(r" in [0-9.]+s", "", line)


def test_launcher_sketch8_matches_jax(capsys):
    argv = ["--n-data", "1200", "--n-query", "64", "--dim", "48",
            "--engine-spec", "ci", "--theta-q", "3", "--quant", "sketch8",
            "--quant-build", "sq8"]
    assert launch.main(["--device", "cpu", *argv]) == 0
    got = capsys.readouterr().out
    assert jlaunch.main(argv) == 0
    want = capsys.readouterr().out
    assert _launch_line(got) == _launch_line(want)
    assert "sound=True" in got and "esc8=" in got
