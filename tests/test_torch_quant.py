"""The sq8 storage tier of the PyTorch port against the JAX package.

On the same numpy inputs: the QuantStore (codes bit-equal, scales equal,
norms and errors to rounding), the int8 distance ops (the port's plain
versions, what its dispatcher runs for CPU tensors, against
``repro.kernels.ops`` at ``impl="ref"`` and ``"pallas_interpret"``), the
certified-bound helpers, the band compaction, the top-k merge (ties and
+inf slots included) and the cascade-driven index build (the neighbor
table equal to the reference's sq8 build and to the port's own f32
build). The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py``).

Tolerances: int8 pairwise ``|Δ| ≤ 1e-5·(xn+yn) + 1e-6`` (matmul form);
int8 rowwise/gather ``|Δ| ≤ 1e-5·value + 1e-6``; bounds ``rtol 1e-6``
(the same formula on norms and errors that agree to rounding); the
top-k merge, the band compaction and the codes exactly.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_index as jbuild_index
from repro.data.vectors import make_dataset
from repro.kernels import ops as jops
from repro.quant import store as jstore
from repro_torch.core import build_index
from repro_torch.core import graph
from repro_torch.kernels import ops, ref
from repro_torch.quant import build_cascade, build_store, quantize_queries

JAX_IMPLS = ("ref", "pallas_interpret")
INT8_PAIRWISE = [(1, 1, 1), (3, 5, 7), (9, 130, 33), (16, 200, 128),
                 (5, 40, 200), (0, 4, 8), (4, 0, 8)]
INT8_ROWS = [(1, 1, 1), (3, 5, 7), (9, 33, 130), (8, 128, 64),
             (0, 4, 8), (3, 0, 8)]


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


def _stores(n, d, key, scale_rows=None):
    """The same table quantized by both packages."""
    v = _rng("v", n, d, key).normal(size=(n, d)).astype(np.float32) * 3
    return (v, build_store(torch.from_numpy(v), scale_rows=scale_rows),
            jstore.build_store(jnp.asarray(v), scale_rows=scale_rows))


@pytest.mark.parametrize("n,d", [(50, 24), (40, 128), (30, 130), (20, 200),
                                 (1, 16)])
def test_store_matches_jax(n, d):
    rows = None if n == 1 else np.arange(n) % 3 != 0
    v, st, jst = _stores(n, d, "store", scale_rows=rows)
    assert st.q.dtype == torch.int8 and st.group_size == jst.group_size
    np.testing.assert_array_equal(st.q.numpy(), np.asarray(jst.q))
    np.testing.assert_array_equal(st.scales.numpy(), np.asarray(jst.scales))
    np.testing.assert_allclose(st.norms.numpy(), np.asarray(jst.norms),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(st.err.numpy(), np.asarray(jst.err),
                               rtol=1e-5, atol=1e-6)
    assert st.nbytes == jst.nbytes
    x = _rng("x", d).normal(size=(7, d)).astype(np.float32) * 4  # clips
    q, norms, err = quantize_queries(torch.from_numpy(x), st)
    jq, jn, je = jstore.quantize_queries(jnp.asarray(x), jst)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(norms.numpy(), np.asarray(jn), rtol=1e-6)
    np.testing.assert_allclose(err.numpy(), np.asarray(je), rtol=1e-5,
                               atol=1e-6)


def _codes(B, N, d, key):
    _, st, jst = _stores(max(N, 1), d, key)
    x = _rng("q", B, d, key).normal(size=(B, d)).astype(np.float32) * 3
    qx = quantize_queries(torch.from_numpy(x), st)[0]
    return st, jst, qx


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("B,N,d", INT8_PAIRWISE)
def test_int8_pairwise_matches_jax(B, N, d, impl):
    st, jst, qx = _codes(B, N, d, "pw")
    qy = st.q[:N]
    got = ops.pairwise_sq_dists_int8(qx, qy, st.scales, xn=None,
                                     yn=st.norms[:N])
    want = np.asarray(jops.pairwise_sq_dists_int8(
        jnp.asarray(qx.numpy()), jnp.asarray(qy.numpy()), jst.scales,
        impl=impl), np.float64)
    assert got.shape == (B, N)
    sd = np.asarray(jstore.dim_scales(jst.scales, d, jst.group_size))
    xn = ((qx.numpy() * sd) ** 2).sum(1)[:, None]
    yn = ((qy.numpy() * sd) ** 2).sum(1)[None, :]
    assert np.all(np.abs(got.numpy() - want) <= 1e-5 * (xn + yn) + 1e-6)


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("B,K,d", INT8_ROWS)
def test_int8_rowwise_and_gather_match_jax(B, K, d, impl):
    st, jst, qx = _codes(B, 40, d, "rw")
    rng = _rng("ids", B, K, d)
    idx = rng.integers(0, 40, (B, K)).astype(np.int32)
    idx[rng.random((B, K)) < 0.4] = -1
    cands = st.q[torch.from_numpy(np.maximum(idx, 0)).long()]
    want = np.asarray(jops.rowwise_sq_dists_int8(
        jnp.asarray(qx.numpy()), jnp.asarray(cands.numpy()), jst.scales,
        impl=impl), np.float64)
    got = ops.rowwise_sq_dists_int8(qx, cands, st.scales).double().numpy()
    assert got.shape == (B, K)
    assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-6)
    # the gather form the traversal uses: rows by id, NO_NODE → +inf
    g = ops.gather_sq_dists_int8(st.q, qx, torch.from_numpy(idx),
                                 st.scales).double().numpy()
    masked = np.where(idx >= 0, want, np.inf)
    assert np.array_equal(np.isfinite(g), np.isfinite(masked))
    fin = np.isfinite(masked)
    assert np.all(np.abs(g[fin] - masked[fin])
                  <= 1e-5 * np.abs(masked[fin]) + 1e-6)


def test_bounds_match_jax():
    rng = _rng("bounds")
    d_hat = rng.uniform(0, 10, (6, 9)).astype(np.float32)
    d_hat[0, :3] = np.inf
    d_hat[1, :2] = 0.0
    slack = rng.uniform(0, 2, (6, 9)).astype(np.float32)
    th2 = np.float32(4.0)
    t, s = torch.from_numpy(d_hat), torch.from_numpy(slack)
    for mine, theirs in ((ops.quant_lower_bound, jops.quant_lower_bound),
                         (ops.quant_upper_bound, jops.quant_upper_bound)):
        np.testing.assert_allclose(mine(t, s).numpy(),
                                   np.asarray(theirs(d_hat, slack)),
                                   rtol=1e-6)
    sure, amb = ops.quant_band_from_lb(t, s, float(th2))
    jsure, jamb = jops.quant_band_from_lb(d_hat, slack, th2)
    np.testing.assert_array_equal(sure.numpy(), np.asarray(jsure))
    np.testing.assert_array_equal(amb.numpy(), np.asarray(jamb))
    lb = ops.quant_lower_bound(t, s)
    ub = ops.quant_upper_bound(t, s)
    assert bool((lb <= t).all()) and bool((ub[t.isfinite()]
                                            >= t[t.isfinite()]).all())


@pytest.mark.parametrize("cap", [1, 3, 8, 16])
def test_band_compaction_matches_jax(cap):
    rng = _rng("band", cap)
    B, C, n, d = 6, 12, 30, 5
    mask = rng.random((B, C)) < 0.4
    mask[0] = False
    ids = rng.integers(0, n, (B, C)).astype(np.int32)
    ids[1, :4] = -1
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    x = rng.normal(size=(B, d)).astype(np.float32)
    tm, ti = torch.from_numpy(mask), torch.from_numpy(ids)
    slots, cand, n_masked = ops.band_compact(tm, ti, cap)
    js, jc, jn = jops.band_compact(jnp.asarray(mask), jnp.asarray(ids), cap)
    np.testing.assert_array_equal(slots.numpy(), np.asarray(js))
    np.testing.assert_array_equal(cand.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(n_masked.numpy(), np.asarray(jn))
    vals = torch.from_numpy(rng.normal(size=(B, cap)).astype(np.float32))
    np.testing.assert_array_equal(
        ops.band_scatter(slots, vals, C).numpy(),
        np.asarray(jops.band_scatter(js, jnp.asarray(vals.numpy()), C)))
    exact, within, nm = ops.compact_gather_sq_dists(
        torch.from_numpy(vecs), torch.from_numpy(x), ti, tm, cap)
    je, jw, jnm = jops.compact_gather_sq_dists(
        jnp.asarray(vecs), jnp.asarray(x), jnp.asarray(ids),
        jnp.asarray(mask), cap, impl="ref")
    np.testing.assert_array_equal(within.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(nm.numpy(), np.asarray(jnm))
    je = np.asarray(je)
    assert np.array_equal(np.isfinite(exact.numpy()), np.isfinite(je))
    fin = np.isfinite(je)
    np.testing.assert_allclose(exact.numpy()[fin], je[fin], rtol=1e-6)


@pytest.mark.parametrize("B,L,K", [(6, 8, 11), (5, 4, 1), (3, 1, 6),
                                   (4, 12, 12)])
def test_topk_merge_matches_jax_kernel(B, L, K):
    rng = _rng("topk", B, L, K)
    # few distinct values: ties between beam and candidates and within
    # the candidates; some +inf slots
    bd = rng.integers(0, 4, (B, L)).astype(np.float32)
    bd[rng.random((B, L)) < 0.2] = np.inf
    bd = np.sort(bd, axis=1)
    cd = rng.integers(0, 4, (B, K)).astype(np.float32)
    cd[rng.random((B, K)) < 0.2] = np.inf
    bi = rng.integers(0, 1000, (B, L)).astype(np.int32)
    ci = rng.integers(0, 1000, (B, K)).astype(np.int32)
    gd, gi = ops.topk_merge(*map(torch.from_numpy, (bd, bi, cd, ci)))
    pd, pi = jops.topk_merge(*map(jnp.asarray, (bd, bi, cd, ci)),
                             impl="pallas_interpret")
    np.testing.assert_array_equal(gd.numpy(), np.asarray(pd))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(pi))
    rd, ri = jops.topk_merge(*map(jnp.asarray, (bd, bi, cd, ci)), impl="ref")
    fin = np.isfinite(np.asarray(rd))
    np.testing.assert_array_equal(gi.numpy()[fin], np.asarray(ri)[fin])
    assert gi.dtype == torch.int32


@pytest.mark.parametrize("regime", ["manifold", "clustered", "ood"])
def test_cascade_build_matches_jax_and_f32(regime):
    ds = make_dataset(regime, n_data=800, n_query=32, dim=32, seed=11)
    want = np.asarray(jbuild_index(ds.Y, k=20, degree=10, quant="sq8").nbrs)
    bs = graph.BuildStats()
    g8 = build_index(ds.Y, k=20, degree=10, quant="sq8", build_stats=bs,
                     device="cpu")
    g32 = build_index(ds.Y, k=20, degree=10, device="cpu")
    np.testing.assert_array_equal(g8.nbrs.numpy(), want)
    np.testing.assert_array_equal(g8.nbrs.numpy(), g32.nbrs.numpy())
    assert bs.f32_bytes < 0.5 * bs.f32_bytes_full, bs.as_dict()
    assert 0 < bs.knn_exact < bs.knn_pairs
    assert 0 <= bs.prune_exact <= bs.prune_pairs
    assert bs.knn_blocks > 0 and bs.knn_sweep_s == 0.0   # timed on the card


def test_cascade_knn_survivor_cap_grows_and_retries():
    """A survivor buffer too small for a row grows and redoes the block;
    the lists do not depend on the starting cap."""
    ds = make_dataset("clustered", n_data=600, n_query=16, dim=24, seed=5)
    v = torch.from_numpy(ds.Y)
    casc = build_cascade(v, "sq8")
    tier = casc.tier("int8")
    vn = ref.sq_norms(v)
    kw = dict(qblock=128, dblock=100, impl=None, stats=None)
    d_big, i_big = graph._cascade_knn(v, vn, tier, 12, init_cap=1024, **kw)
    d_small, i_small = graph._cascade_knn(v, vn, tier, 12, init_cap=12, **kw)
    assert torch.equal(i_big, i_small) and torch.equal(d_big, d_small)
    # the f32 sweep selects the same neighbors; on the CPU the plain
    # pair-list and matmul forms round apart, so near-ties may swap order
    d32, i32 = graph.exact_knn(v, 12, qblock=128, dblock=100)
    assert torch.equal(i32.sort(dim=1)[0], i_big.sort(dim=1)[0])
    torch.testing.assert_close(d32, d_big, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tier", ["int8", "sketch1", "pdx"])
def test_store_builders_put_an_array_on_the_card_by_default(tier):
    """A numpy table given with no device goes to the card, as
    ``build_index`` places it: where no card is visible the build
    raises, and ``device="cpu"`` builds on the CPU. A tensor keeps its
    device."""
    from repro_torch.quant.cascade import build_tier_store

    def devices(st) -> set:
        return {t.device.type for t in vars(st).values()
                if isinstance(t, torch.Tensor)}
    v = _rng("dev", tier).normal(size=(20, 16)).astype(np.float32)
    if torch.cuda.is_available():
        assert devices(build_tier_store(tier, v)) == {"cuda"}
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_tier_store(tier, v)
    assert devices(build_tier_store(tier, v, device="cpu")) == {"cpu"}
    assert devices(build_tier_store(tier, torch.from_numpy(v))) == {"cpu"}


def test_unported_tiers_raise():
    """Every tier of the reference is ported (sketch8 and pdx8 build their
    chains); a tier name that is not one of them is refused."""
    from repro_torch.quant.cascade import build_tier_store, tier_class
    v = torch.zeros((4, 8))
    assert build_cascade(v, "sketch8").names == ("sketch1", "int8")
    assert build_cascade(v, "pdx8").names == ("pdx",)
    assert build_cascade(v, "sketchpdx8").names == ("sketch1", "pdx")
    with pytest.raises(ValueError, match="unknown tier"):
        tier_class("int4")
    with pytest.raises(ValueError, match="unknown tier"):
        build_tier_store("int4", v)
    assert build_cascade(v, "off") is None
