"""The PDX tier of the PyTorch port (pdx8, sketchpdx8) against the JAX
package.

On the same numpy inputs: the PDX ops (the port's plain versions, what its
dispatcher runs for CPU tensors) against ``repro.kernels.ops`` at
``impl="ref"`` and ``"pallas_interpret"`` — ``dhat`` within ``rtol 1e-6,
atol 1e-6·(xn+yn)``, ``nscan`` exact on inputs whose partial sums stay
clear of the threshold, survivors bit-identical with early exit on and
off; the PdxStore (permutation, scales, permuted rows and codes equal —
codes but for counted half-way values —, energies within 1e-5 relative);
the tail bounds against float64; the pdx8 and sketchpdx8 joins (``es_mi``
/ ``es_mi_adapt`` on the reference's merged index with its stores carried
across, against the JAX engine with overlap off: identical pairs,
``n_dist``, ``n_iters``, ``n_esc8``, ``n_rerank``, ``overflow_retries``,
``n_dims_scanned``) and their NLJs (pairs equal to JAX's and to the f32
truth, counts equal, early exit on and off); one pair set across all five
quant modes; the launcher; and the engine's store sharing across modes.
The PDX tier's certified bounds — ``ref.pairwise_bounds_pdx``, the plain
version of the fused PDX bounds kernel — against the reference's
``PdxTier.pairwise_bounds_ee`` on carried stores (``nscan`` exact, bounds
within ``2e-5·(xn+yn) + 1e-6·|value|``), the port's tier on the CPU bit
for bit that plain version, and the NLJ's count of scanned dimensions.
"""
import dataclasses
import re
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import JoinConfig as JJoinConfig
from repro.core import TraversalConfig as JTraversalConfig
from repro.core import build_merged_index as jbuild_merged
from repro.core import exact_join_pairs as jexact
from repro.core.join import cascade_join_pairs as jcascade_join
from repro.data.vectors import make_dataset, thresholds
from repro.engine import JoinEngine as JJoinEngine
from repro.kernels import ops as jops
from repro.launch import join as jlaunch
from repro.quant import cascade as jcascade
from repro.quant import pdx as jpdx
from repro_torch.configs.vectorjoin import make_engine
from repro_torch.core import JoinConfig, TraversalConfig, exact_join_pairs
from repro_torch.core.join import cascade_join_pairs
from repro_torch.core.types import (QUANT_MODES, graph_index_from_numpy,
                                    pair_keys)
from repro_torch.engine import JoinEngine
from repro_torch.kernels import ops, ref
from repro_torch.launch import join as launch
from repro_torch.quant import cascade, pdx, sketch
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


def _table(key, n, d):
    """Rows whose dimensions differ in variance (so the permutation and the
    per-slab tails matter)."""
    rng = _rng("tab", key, n, d)
    return (rng.normal(size=(n, d)) * rng.uniform(0.2, 3.0, d)
            ).astype(np.float32)


def _carry_pdx(jst) -> pdx.PdxStore:
    return pdx.pdx_store_from_numpy(
        *(np.asarray(getattr(jst, f)) for f in (
            "perm", "vp", "ftail", "q", "scales", "qslab", "qtail", "norms",
            "err")), jst.slab, jst.dim, device=CPU)


def _carry_queries(jq) -> pdx.PdxQueries:
    return pdx.PdxQueries(**{f.name: torch.tensor(np.asarray(getattr(jq,
                                                                     f.name)))
                             for f in dataclasses.fields(pdx.PdxQueries)})


# -- the store -----------------------------------------------------------------

@pytest.mark.parametrize("n,d,slab", [(300, 40, 64), (200, 130, 64),
                                      (100, 96, 32)])
def test_pdx_store_matches_jax(n, d, slab):
    v = _table("store", n, d)
    rows = np.arange(n) % 5 != 0
    st = pdx.build_pdx(torch.from_numpy(v), slab=slab, scale_rows=rows)
    jst = jpdx.build_pdx(v, slab=slab, scale_rows=rows)
    np.testing.assert_array_equal(st.perm.numpy(), np.asarray(jst.perm))
    np.testing.assert_array_equal(st.scales.numpy(), np.asarray(jst.scales))
    np.testing.assert_array_equal(st.vp.numpy(), np.asarray(jst.vp))
    assert (st.slab, st.dim, st.n_slabs) == (jst.slab, jst.dim, jst.n_slabs)
    assert st.nbytes == jst.nbytes
    # codes: the same IEEE division and round-half-even; count any code
    # that differs and check it sat on a half-way value
    q, jq = st.q.numpy(), np.asarray(jst.q)
    diff = np.argwhere(q != jq)
    assert len(diff) <= 2
    sd = np.repeat(np.asarray(jst.scales), slab)
    for r, c in diff:
        frac = abs(np.asarray(jst.vp)[r, c] / sd[c]) % 1.0
        assert abs(frac - 0.5) < 1e-4
    for f in ("ftail", "qslab", "qtail", "norms"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(jst, f)), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(st.err.numpy(), np.asarray(jst.err),
                               rtol=1e-5, atol=1e-6)
    # the tails are certified: ftail[:, k] is the energy of slabs k..
    vp64 = np.asarray(jst.vp, np.float64).reshape(n, -1, slab)
    e64 = (vp64 ** 2).sum(2)[:, ::-1].cumsum(1)[:, ::-1]
    np.testing.assert_allclose(st.ftail.numpy(), e64, rtol=1e-5)
    x = _table("q", 7, d) * 1.3
    qc, jqc = pdx.pdx_queries(torch.from_numpy(x), st), jpdx.pdx_queries(x,
                                                                         jst)
    np.testing.assert_array_equal(qc.vp.numpy(), np.asarray(jqc.vp))
    assert (qc.q.numpy() != np.asarray(jqc.q)).sum() <= 2


# -- the PDX ops ---------------------------------------------------------------

def _pdx_case(B, N, d, slab, key):
    jst = jpdx.build_pdx(_table(key, max(N, 1), d), slab=slab)
    jq = jpdx.pdx_queries(_table((key, "x"), B, d), jst)
    return jst, jq


def _thetas(jst, jq):
    """A threshold where lanes retire and one where they survive."""
    x, y = np.asarray(jq.vp), np.asarray(jst.vp)
    if not x.size or not y.size:
        return [1.0]
    med = float(np.median(((x[:, None] - y[None]) ** 2).sum(-1)))
    return [float(np.sqrt(0.45 * med)), float(np.sqrt(1.2 * med))]


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("B,N,d,slab", [(1, 1, 8, 8), (5, 9, 40, 64),
                                        (9, 130, 96, 32), (12, 40, 130, 64),
                                        (0, 4, 16, 8), (4, 0, 16, 8)])
def test_pairwise_pdx_matches_jax(B, N, d, slab, impl):
    jst, jq = _pdx_case(B, N, d, slab, "pw")
    st, qc = _carry_pdx(jst), _carry_queries(jq)
    st = dataclasses.replace(st, **{f: getattr(st, f)[:N] for f in (
        "vp", "ftail", "q", "qslab", "qtail", "norms", "err")})
    for theta in _thetas(jst, jq):
        targs = (qc.q, st.q, st.scales, qc.qslab, st.qslab, qc.qtail,
                 st.qtail, qc.norms, st.norms, qc.err, st.err, theta)
        jargs = tuple(jnp.asarray(a.numpy()) for a in targs[:-1]) + (theta,)
        kw = dict(slab=slab, dim=d)
        outs = {}
        for ee in (False, True):
            got, gn = ops.pairwise_sq_dists_pdx(*targs, early_exit=ee, **kw)
            want, wn = jops.pairwise_sq_dists_pdx(*jargs, early_exit=ee,
                                                  impl=impl, **kw)
            want, wn = np.asarray(want, np.float64), np.asarray(wn)
            assert got.shape == (B, N) and gn.dtype == torch.int32
            energy = (qc.norms[:, None] + st.norms[None, :]).numpy()
            fin = np.isfinite(want)
            # nscan exact where the partial sums clear the threshold (a
            # lane within 1e-4 relative of it may round the other way)
            np.testing.assert_array_equal(np.isfinite(got.numpy()), fin)
            np.testing.assert_array_equal(gn.numpy(), wn)
            assert np.all(np.abs(got.numpy()[fin] - want[fin])
                          <= 1e-6 * np.abs(want[fin]) + 1e-6 * energy[fin])
            outs[ee] = (got, gn)
        (off, n_off), (on, n_on) = outs[False], outs[True]
        surv = n_on == st.n_slabs
        assert torch.equal(on[surv], off[surv])          # bit-identical
        assert bool(torch.isinf(on[~surv]).all())
        assert bool((n_off == st.n_slabs).all())


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("B,K,d,slab", [(1, 1, 8, 8), (5, 9, 40, 64),
                                        (9, 33, 96, 32), (6, 20, 130, 64),
                                        (0, 4, 16, 8), (3, 0, 16, 8)])
def test_pdx_gather_matches_jax(B, K, d, slab, impl):
    jst, jq = _pdx_case(B, 50, d, slab, "g")
    st, qc = _carry_pdx(jst), _carry_queries(jq)
    rng = _rng("gid", B, K, d)
    idx = rng.integers(0, 50, (B, K)).astype(np.int32)
    idx[rng.random((B, K)) < 0.3] = -1
    vn, xn = st.ftail[:, 0].contiguous(), qc.ftail[:, 0].contiguous()
    for theta in _thetas(jst, jq):
        th2 = float(np.float32(theta) ** 2)
        outs = {}
        for ee in (False, True):
            got, gn = ops.pdx_gather_sq_dists(
                st.vp, st.ftail, vn, qc.vp, qc.ftail, xn,
                torch.from_numpy(idx), th2, dim=d, early_exit=ee)
            want, wn = jops.pdx_gather_sq_dists(
                jst.vp, jst.ftail, jst.ftail[:, 0], jq.vp, jq.ftail,
                jq.ftail[:, 0], jnp.asarray(idx), np.float32(th2), dim=d,
                early_exit=ee, impl=impl)
            want, wn = np.asarray(want, np.float64), np.asarray(wn)
            fin = np.isfinite(want)
            np.testing.assert_array_equal(np.isfinite(got.numpy()), fin)
            np.testing.assert_array_equal(gn.numpy(), wn)
            assert np.all(np.abs(got.numpy()[fin] - want[fin])
                          <= 1e-6 * np.abs(want[fin]) + 1e-6)
            outs[ee] = (got, gn)
        (off, _), (on, n_on) = outs[False], outs[True]
        surv = torch.from_numpy(idx >= 0) & (n_on == st.n_slabs)
        assert torch.equal(on[surv], off[surv])


def _old_pdx_compact(vp, vtail, vnorm, xp, xtail, xn, ids, mask, cap, th2,
                     *, dim, early_exit):
    """The composition ``ops.pdx_compact_gather_sq_dists`` ran before the
    fused band re-rank kernel, as it stood."""
    C = ids.shape[1]
    slots, cand, n_masked = ops.band_compact(mask, ids, cap)
    dist_c, nscan_c = ops.pdx_gather_sq_dists(
        vp, vtail, vnorm, xp, xtail, xn, cand, th2, dim=dim,
        early_exit=early_exit)
    exact = ops.band_scatter(slots, dist_c, C)
    within = mask & (torch.cumsum(mask, dim=1) - 1 < cap)
    slab = vp.shape[1] // vtail.shape[1]
    valid = cand >= 0
    n_scanned = torch.sum(torch.where(
        valid, torch.clamp_max(nscan_c.long() * slab, dim), 0))
    n_total = torch.sum(valid) * dim
    return exact, within, n_masked, n_scanned, n_total


# (B, C, cap, d, slab): cap below the band (the retry case), cap = C, a
# slab that is not a multiple of 4, two slabs of 64
COMPACT_CASES = [(6, 40, 8, 128, 64), (5, 33, 33, 70, 30), (4, 24, 5, 40, 8)]


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("B,C,cap,d,slab", COMPACT_CASES)
def test_pdx_compact_gather_matches_jax(B, C, cap, d, slab, impl):
    """``ref.pdx_compact_gather_sq_dists`` (the plain version of the fused
    band re-rank kernel, what the dispatcher runs on the CPU) against the
    reference's ``pdx_compact_gather_sq_dists`` on a carried store, early
    exit on and off, with an empty band row and NO_NODE inside the band:
    ``within``, ``n_masked`` and both scan counters equal, ``exact``
    finite at the same slots and within the PDX gather's tolerance; and
    bit for bit the composition it replaced."""
    jst, jq = _pdx_case(B, 50, d, slab, "cg")
    st, qc = _carry_pdx(jst), _carry_queries(jq)
    rng = _rng("cg", B, C, cap, d)
    ids = rng.integers(0, 50, (B, C)).astype(np.int32)
    ids[rng.random((B, C)) < 0.2] = -1
    mask = rng.random((B, C)) < 0.6
    mask[1] = False                                   # an empty band row
    assert (mask & (ids < 0)).any()                   # NO_NODE in the band
    vn, xn = st.ftail[:, 0].contiguous(), qc.ftail[:, 0].contiguous()
    t_ids, t_mask = torch.from_numpy(ids), torch.from_numpy(mask)
    for theta in _thetas(jst, jq):
        th2 = float(np.float32(theta) ** 2)
        args = (st.vp, st.ftail, vn, qc.vp, qc.ftail, xn, t_ids, t_mask, cap,
                th2)
        for ee in (False, True):
            got = ops.pdx_compact_gather_sq_dists(*args, dim=d, early_exit=ee)
            plain = ref.pdx_compact_gather_sq_dists(*args, dim=d,
                                                    early_exit=ee)
            old = _old_pdx_compact(*args, dim=d, early_exit=ee)
            for g, p, o in zip(got, plain, old):
                assert torch.equal(g, p) and torch.equal(p, o)
            want = jops.pdx_compact_gather_sq_dists(
                jst.vp, jst.ftail, jst.ftail[:, 0], jq.vp, jq.ftail,
                jq.ftail[:, 0], jnp.asarray(ids), jnp.asarray(mask), cap,
                np.float32(th2), dim=d, early_exit=ee, impl=impl)
            we, ww, wm, ws, wt = (np.asarray(w) for w in want)
            exact, within, n_masked, n_scanned, n_total = plain
            fin = np.isfinite(we)
            np.testing.assert_array_equal(np.isfinite(exact.numpy()), fin)
            assert np.all(np.abs(exact.numpy()[fin] - we[fin])
                          <= 1e-6 * np.abs(we[fin]) + 1e-6)
            np.testing.assert_array_equal(within.numpy(), ww)
            np.testing.assert_array_equal(n_masked.numpy(), wm)
            assert int(n_scanned) == int(ws) and int(n_total) == int(wt)
            assert n_scanned.dtype == n_total.dtype == torch.int64
            assert int(n_masked[1]) == 0 and not within[1].any()
            if cap < C:
                assert int(n_masked.max()) > cap     # the retry case


@pytest.mark.parametrize("seed", range(3))
def test_pdx_retirement_is_certified(seed):
    """A lane the plain PDX sweep retires has a certified lower bound on
    its float64 distance beyond θ² (the pdx8 NLJ relies on it)."""
    rng = _rng("cert", seed)
    v = _table(("cert", seed), 200, 150)
    x = (v[:30] + rng.normal(size=(30, 150)) * 0.5).astype(np.float32)
    st = pdx.build_pdx(torch.from_numpy(v))
    qc = pdx.pdx_queries(torch.from_numpy(x), st)
    tier = cascade.PdxTier(st)
    d64 = ((x.astype(np.float64)[:, None] - v.astype(np.float64)[None])
           ** 2).sum(-1)
    theta = float(np.sqrt(np.median(d64) * 0.6))
    lb, ub, nscan = tier.pairwise_bounds_ee(qc, theta=theta, early_exit=True,
                                            impl=None)
    lb0, ub0 = tier.pairwise_bounds(qc, impl=None)
    retired = (nscan < st.n_slabs).numpy()
    assert retired.any() and not retired.all()
    assert np.all(d64[retired] > np.float32(theta) ** 2)
    assert np.all(lb0.numpy()[retired] > np.float32(theta) ** 2)
    assert np.all(lb0.double().numpy() <= d64 * (1 + 1e-6))
    assert np.all(ub0.double().numpy() >= d64 * (1 - 1e-6))
    keep = ~retired
    assert torch.equal(lb[keep], lb0[keep]) and torch.equal(ub[keep],
                                                            ub0[keep])


# -- the PDX tier's certified bounds (the fused kernel's plain version) --------

_ROW_FIELDS = ("vp", "ftail", "q", "qslab", "qtail", "norms", "err")
# (B, N, d, slab): one slab of 8, one short slab, slabs of 32, three slabs
# with padding, empty
BOUND_SHAPES = [(1, 1, 8, 8), (5, 9, 40, 64), (9, 130, 96, 32),
                (12, 40, 130, 64), (0, 4, 16, 8), (4, 0, 16, 8)]


def _bounds_case(B, N, d, slab):
    """The reference's store over N rows and its queries, and both carried
    into the port."""
    jst, jq = _pdx_case(B, N, d, slab, "pb")
    jst = dataclasses.replace(jst, **{f: getattr(jst, f)[:N]
                                      for f in _ROW_FIELDS})
    return _carry_pdx(jst), _carry_queries(jq), jst, jq


def _plain_bounds(st, qc, theta, early_exit):
    return ref.pairwise_bounds_pdx(
        qc.q, st.q, st.scales, qc.qslab, st.qslab, qc.qtail, st.qtail,
        qc.norms, st.norms, qc.err, st.err, theta, slab=st.slab, dim=st.dim,
        early_exit=early_exit)


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("B,N,d,slab", BOUND_SHAPES)
def test_plain_bounds_match_the_reference_tier(B, N, d, slab, impl):
    """``ref.pairwise_bounds_pdx`` against the reference's
    ``PdxTier.pairwise_bounds_ee`` on the same carried store: ``nscan``
    exact, +inf where the reference's is, finite bounds within
    ``2e-5·(xn+yn) + 1e-6·|value|`` (the two d̂ differ by the matmul
    form's rounding; the chain is about 1-Lipschitz in d̂ where d̂ dwarfs
    the slack)."""
    st, qc, jst, jq = _bounds_case(B, N, d, slab)
    jtier = jcascade.PdxTier(jst)
    nsum = (qc.norms[:, None] + st.norms[None, :]).double().numpy()
    for theta in _thetas(jst, jq):
        for ee in (False, True):
            lb, ub, nscan = _plain_bounds(st, qc, theta, ee)
            jlb, jub, jn = jtier.pairwise_bounds_ee(
                jq, theta=theta, early_exit=ee, impl=impl)
            assert lb.shape == ub.shape == nscan.shape == (B, N)
            assert nscan.dtype == torch.int32
            np.testing.assert_array_equal(nscan.numpy(), np.asarray(jn))
            for got, want in ((lb, jlb), (ub, jub)):
                got = got.double().numpy()
                want = np.asarray(want, np.float64)
                fin = np.isfinite(want)
                np.testing.assert_array_equal(np.isfinite(got), fin)
                assert np.all(np.abs(got[fin] - want[fin])
                              <= 2e-5 * nsum[fin] + 1e-6 * np.abs(want[fin]))
            if ee:                       # a retired lane: +inf in both
                ret = (nscan < st.n_slabs).numpy()
                assert np.all(np.isinf(lb.numpy()[ret]))
                assert np.all(np.isinf(ub.numpy()[ret]))


@pytest.mark.parametrize("B,N,d,slab", BOUND_SHAPES)
def test_tier_sweep_on_the_cpu_is_the_plain_bounds(B, N, d, slab):
    """``PdxTier.pairwise_bounds_ee`` (and ``pairwise_bounds``) on CPU
    tensors run ``ref.pairwise_bounds_pdx`` bit for bit, launching
    nothing; on rows [y0, N) too."""
    st, qc, jst, jq = _bounds_case(B, N, d, slab)
    tier = cascade.PdxTier(st)
    thetas = _thetas(jst, jq)
    n0 = ops.launch_counts()
    for theta in thetas:
        for ee in (False, True):
            got = tier.pairwise_bounds_ee(qc, theta=theta, early_exit=ee,
                                          impl=None)
            for g, w in zip(got, _plain_bounds(st, qc, theta, ee)):
                assert torch.equal(g, w)
    lb, ub = tier.pairwise_bounds(qc, impl=None)
    wlb, wub, _ = _plain_bounds(st, qc, 0.0, False)
    assert torch.equal(lb, wlb) and torch.equal(ub, wub)
    y0 = min(N, 3)
    got = tier.pairwise_bounds_ee(qc, theta=thetas[0], early_exit=True,
                                  impl=None, y0=y0)
    sub = dataclasses.replace(st, **{f: getattr(st, f)[y0:]
                                     for f in _ROW_FIELDS})
    for g, w in zip(got, _plain_bounds(sub, qc, thetas[0], True)):
        assert torch.equal(g, w)
    assert ops.launch_counts() == n0
    with pytest.raises(ValueError):
        ops.pairwise_bounds_pdx(
            qc.q, st.q, st.scales, qc.qslab, st.qslab, qc.qtail, st.qtail,
            qc.norms, st.norms, qc.err, st.err, 1.0, slab=st.slab,
            dim=st.dim, impl="cuda")


@pytest.mark.parametrize("d,slab", [(100, 64), (130, 64), (96, 32)])
def test_nlj_dims_scanned_is_the_clamped_sum(d, slab):
    """The NLJ counts a lane's dims as nscan·slab clamped to d (only a full
    scan is clamped), summed without a (B, N) int64 tensor; its total
    equals that sum over the sweep's own slab counts."""
    v, x = _table(("nlj", d), 300, d), _table(("nljx", d), 40, d)
    st = pdx.build_pdx(torch.from_numpy(v), slab=slab)
    tier = cascade.PdxTier(st)
    med = float(np.median(((x.astype(np.float64)[:, None] - v[None]) ** 2)
                          .sum(-1)))
    theta = float(np.sqrt(0.45 * med))
    _, counts = cascade_join_pairs(x, v, theta, cascade.FilterCascade(
        (tier,)), block=16, device=CPU)
    want = 0
    for q0 in range(0, 40, 16):
        qc = tier.encode(torch.from_numpy(x[q0:q0 + 16]))
        _, _, nscan = tier.pairwise_bounds_ee(qc, theta=theta,
                                              early_exit=True, impl=None)
        want += int(torch.clamp_max(nscan.long() * slab, d).sum())
    assert 0 < counts["dims_scanned"] == want < counts["dims_total"]
    assert counts["dims_total"] == 40 * 300 * d


# -- the pdx8 / sketchpdx8 joins --------------------------------------------------------

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


def _carried_stores(mode: str, vecs) -> dict:
    """The reference's tier stores of ``mode`` over ``vecs``, as the port's."""
    out = {}
    for name in jcascade.TIERS_BY_MODE[mode]:
        st = jcascade.build_tier_store(name, vecs)
        if name == "pdx":
            out[name] = _carry_pdx(st)
        elif name == "sketch1":
            out[name] = sketch.sketch_store_from_numpy(
                *(np.asarray(getattr(st, f)) for f in (
                    "codes", "cum", "hs", "mu", "rot", "iso")), device=CPU)
        else:
            out[name] = QuantStore(*(torch.tensor(np.asarray(getattr(st, f)))
                                     for f in ("q", "scales", "norms",
                                               "err")), st.group_size)
    return out


@pytest.fixture(scope="module")
def cases(ds_manifold, index_merged, ds_ood):
    wide = make_dataset("manifold", n_data=1200, n_query=64, dim=150, seed=3)
    return {
        "manifold": (ds_manifold, index_merged,
                     _clear_theta(ds_manifold,
                                  float(thresholds(ds_manifold, 3)[1]))),
        "ood": (ds_ood, jbuild_merged(ds_ood.Y, ds_ood.X, k=32, degree=16),
                _clear_theta(ds_ood, float(thresholds(ds_ood, 3)[1]))),
        # three slabs: the band re-rank can retire lanes mid-vector
        "wide": (wide, jbuild_merged(wide.Y, wide.X, k=24, degree=12),
                 _clear_theta(wide, float(thresholds(wide, 3)[2]))),
    }


MI_CASES = [("manifold", "es_mi", "pdx8"),
            ("manifold", "es_mi_adapt", "sketchpdx8"),
            ("ood", "es_mi_adapt", "pdx8"), ("ood", "es_mi", "sketchpdx8"),
            ("wide", "es_mi", "pdx8")]


@pytest.mark.parametrize("name,method,mode", MI_CASES)
def test_pdx_mi_join_identical_to_jax(cases, name, method, mode):
    ds, jidx, theta = cases[name]
    jcfg = JJoinConfig(method=method, theta=theta, wave_size=WAVE,
                       quant=mode, overlap=False,
                       traversal=JTraversalConfig(rerank_cap=CAP))
    want = JJoinEngine(ds.Y, default=jcfg).join(ds.X, index_merged=jidx)
    idx = graph_index_from_numpy(
        np.asarray(jidx.vecs), np.asarray(jidx.nbrs), np.asarray(jidx.start),
        np.asarray(jidx.mean_nbr_dist), jidx.n_data, CPU)
    stores = _carried_stores(mode, np.asarray(jidx.vecs))
    n = ds.Y.shape[0]
    got = {}
    for ee in (True, False):
        cfg = JoinConfig(method=method, theta=theta, wave_size=WAVE,
                         quant=mode, traversal=TraversalConfig(
                             rerank_cap=CAP, early_exit=ee))
        eng = JoinEngine(ds.Y, default=cfg, device=CPU)
        eng.adopt(X=ds.X, index_merged=idx, tier_stores=stores)
        got[ee] = eng.join(ds.X)
        assert eng.n_index_builds == 0
    r = got[True]
    np.testing.assert_array_equal(pair_keys(r.pairs, n),
                                  pair_keys(want.pairs, n))
    for f in ("n_dist", "n_iters", "n_esc8", "n_rerank", "n_ood",
              "n_overflow", "n_dims_scanned", "n_dims_total", "quant_bytes"):
        assert getattr(r.stats, f) == getattr(want.stats, f), f
    assert r.stats.overflow_retries >= want.stats.overflow_retries
    # early exit off: the same pairs and re-rank band, a full scan
    np.testing.assert_array_equal(pair_keys(got[False].pairs, n),
                                  pair_keys(r.pairs, n))
    assert got[False].stats.n_rerank == r.stats.n_rerank
    assert got[False].stats.dims_scanned_frac == 1.0
    if name == "wide":
        assert r.stats.dims_scanned_frac < 1.0


@pytest.mark.parametrize("name,mode", [("manifold", "pdx8"),
                                       ("ood", "sketchpdx8"),
                                       ("wide", "pdx8")])
def test_pdx_nlj_equals_jax_and_the_f32_truth(cases, name, mode):
    ds, _, theta = cases[name]
    n = ds.Y.shape[0]
    truth = pair_keys(jexact(ds.X, ds.Y, theta), n)
    jc = jcascade.build_cascade(ds.Y, mode)
    casc = cascade.make_cascade(list(_carried_stores(mode, ds.Y).items()))
    counts = {}
    for ee in (True, False):
        want, jcounts = jcascade_join(ds.X, ds.Y, theta, jc, early_exit=ee)
        got, counts[ee] = cascade_join_pairs(
            ds.X, torch.from_numpy(ds.Y), theta, casc, early_exit=ee)
        np.testing.assert_array_equal(pair_keys(got, n), pair_keys(want, n))
        np.testing.assert_array_equal(pair_keys(got, n), truth)
        assert counts[ee] == jcounts
    assert counts[True]["n_rerank"] == counts[False]["n_rerank"]
    if mode == "pdx8":
        assert counts[True]["dims_scanned"] < counts[True]["dims_total"]
        assert counts[False]["dims_scanned"] == counts[False]["dims_total"]
    else:
        assert counts[True]["escalated"][0] > 0


# -- one pair set across all five modes (mirrors tests/test_quant_modes.py) --

GOLDEN_TC = TraversalConfig(beam_width=64, expand_per_iter=4, pool_cap=1024,
                            hybrid_beam=64, seeds_max=8, max_iters=2048)


def test_golden_identical_pair_set_across_modes():
    """The NLJ is exact under every mode, and es_mi reaches full recall at
    this budget in f32, so every mode emits the identical, exact set."""
    ds = make_dataset("manifold", n_data=1500, n_query=96, dim=40, seed=42)
    theta = float(thresholds(ds, 3)[0])
    eng = JoinEngine(ds.Y, build_kw=dict(k=24, degree=12), device=CPU)
    truth = set(map(tuple, exact_join_pairs(ds.X, eng.Y, theta).tolist()))
    assert len(truth) > 0
    for method in ("nlj", "es_mi"):
        for quant in QUANT_MODES:
            cfg = JoinConfig(method=method, theta=theta, traversal=GOLDEN_TC,
                             wave_size=64, quant=quant)
            assert eng.join(ds.X, cfg).pair_set() == truth, (method, quant)
    assert eng.build_counts == {"index_y": 0, "index_x": 0, "merged": 1,
                                "sharded": 0, "quant": 2, "sketch": 2,
                                "pdx": 2}


def test_stores_are_shared_across_modes(ds_manifold):
    """One engine serves every mode from one tier-store cache: a sketch8
    join reuses the int8 store an sq8 join built, sketchpdx8 reuses the
    sketch and PDX stores; pdx8 as the build mode builds in f32."""
    Y, X = ds_manifold.Y[:500], ds_manifold.X[:32]
    theta = float(thresholds(ds_manifold, 3)[1])
    eng = make_engine(Y, "serving_sketch8", k=12, degree=8, device=CPU)
    assert eng.default.quant == "sketch8"
    truth = pair_keys(exact_join_pairs(X, eng.Y, theta), 500)
    for mode in ("sketch8", "sq8", "pdx8", "sketchpdx8"):
        r = eng.join(X, JoinConfig(theta=theta, quant=mode))
        assert np.setdiff1d(pair_keys(r.pairs, 500), truth).size == 0
    assert eng.build_counts == {"index_y": 0, "index_x": 0, "merged": 1,
                                "sharded": 0, "quant": 1, "sketch": 1,
                                "pdx": 1}
    f32 = JoinEngine(Y, build_kw=dict(k=12, degree=8), device=CPU)
    pd = JoinEngine(Y, build_kw=dict(k=12, degree=8, quant="pdx8"),
                    device=CPU)
    assert torch.equal(pd.merged_index(X).nbrs, f32.merged_index(X).nbrs)
    assert pd.build_counts["quant"] == 0


def _launch_line(out: str) -> str:
    line = next(ln for ln in out.splitlines() if " pairs in " in ln)
    return re.sub(r" in [0-9.]+s", "", line)


def test_launcher_pdx8_matches_jax(capsys):
    argv = ["--n-data", "1200", "--n-query", "64", "--dim", "150",
            "--engine-spec", "ci", "--theta-q", "3", "--quant", "pdx8"]
    assert launch.main(["--device", "cpu", *argv]) == 0
    got = capsys.readouterr().out
    assert jlaunch.main(argv) == 0
    want = capsys.readouterr().out
    assert _launch_line(got) == _launch_line(want)
    assert "sound=True" in got and "dims_frac=" in got
