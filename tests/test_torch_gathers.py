"""The gather kernels' pair-list entries and the int8 tier's fused gather
bounds, on the CPU, against the JAX package.

On the CPU each entry runs its plain version (``kernels/ref.py``):

* ``ops.gather_sq_dists_pairs`` and the d̂ behind the int8 bounds' pair
  list (``ref.gather_sq_dists_int8_pairs``) against the reference's
  ``gather_sq_dists`` / ``rowwise_sq_dists_int8``
  over the pairs' query rows copied out (``x[qi]``), within ``rtol =
  1e-6`` of the value plus ``1e-6`` (torch and XLA sum in another order);
  and bit for bit the port's own (B, K) entries over that copy, which is
  what the callers ran before;
* ``Int8Tier.gather_bounds`` / ``PdxTier.gather_bounds`` and their
  ``pair_refine`` (now one entry, ``ops.gather_bounds_int8`` and its pair
  list) against the reference's tiers on a carried store within
  ``1e-5·value + 1e-5`` (d̂ differs by the sum order; both bounds are at
  most 2-Lipschitz in √d̂), and bit for bit the eager composition they
  replaced.

NO_NODE (-1) ids give +inf (the reference gathers row -1 there, so it is
compared on the valid slots only). Shapes: K = 1, d ∈ {7, 33, 128, 150},
groups of 128, of 64 (a PDX slab) and of 12.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.quant import cascade as jcascade
from repro.quant import pdx as jpdx
from repro.quant import store as jstore
from repro_torch.kernels import ops, ref
from repro_torch.quant import pdx
from repro_torch.quant.cascade import Int8Queries, Int8Tier, PdxTier
from repro_torch.quant.store import QuantStore

DIMS = [7, 33, 128, 150]
# (B, K): one id a lane, a ragged tile, an empty side
LANES = [(3, 1), (9, 17), (0, 4), (5, 0)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (the suite's parallel workers hold every core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _ids(rng, B, K, n, frac_none=0.3):
    i = rng.integers(0, n, (B, K)).astype(np.int32)
    i[rng.random((B, K)) < frac_none] = -1
    return i


def _pairs(rng, B, n, P):
    """P (query, data) pairs, query-major as ``nonzero`` gives them."""
    qi = np.sort(rng.integers(0, B, P)).astype(np.int32)
    return qi, rng.integers(0, n, P).astype(np.int32)


def _close(got: torch.Tensor, want: np.ndarray, rtol=1e-6, atol=1e-6):
    got = got.double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= rtol * np.abs(want) + atol)


def _carried_int8(N, d, gs, B, key):
    """The reference's int8 store over N rows and B queries encoded on its
    grid, carried into the port (both packages then see the same codes)."""
    rng = _rng("i8", key, N, d, gs, B)
    v = rng.normal(size=(N, d)).astype(np.float32) * 2
    jst = jstore.build_store(jnp.asarray(v), group_size=gs)
    st = QuantStore(*(torch.from_numpy(np.array(getattr(jst, f)))
                      for f in ("q", "scales", "norms", "err")), gs)
    jq = jcascade.Int8Tier(jst).encode(
        jnp.asarray(rng.normal(size=(B, d)).astype(np.float32) * 2))
    qc = Int8Queries(*(torch.from_numpy(np.array(getattr(jq, f)))
                       for f in ("q", "norms", "err")))
    return st, jst, qc, jq


def _carried_pdx(N, d, B, key):
    rng = _rng("pdx", key, N, d, B)
    v = (rng.normal(size=(N, d)) * rng.uniform(0.2, 3.0, d)).astype(
        np.float32)
    jst = jpdx.build_pdx(v, slab=64)
    st = pdx.pdx_store_from_numpy(
        *(np.asarray(getattr(jst, f)) for f in (
            "perm", "vp", "ftail", "q", "scales", "qslab", "qtail", "norms",
            "err")), jst.slab, jst.dim, device="cpu")
    jq = jpdx.pdx_queries(rng.normal(size=(B, d)).astype(np.float32), jst)
    qc = pdx.PdxQueries(**{f: torch.from_numpy(np.array(getattr(jq, f)))
                           for f in ("vp", "ftail", "q", "qslab", "qtail",
                                     "norms", "err")})
    return st, jst, qc, jq


# -- the pair-list entries ---------------------------------------------------

@pytest.mark.parametrize("d", DIMS)
def test_f32_pair_entry_matches_the_reference(d):
    rng = _rng("f32pairs", d)
    vecs = rng.normal(size=(40, d)).astype(np.float32)
    x = rng.normal(size=(6, d)).astype(np.float32)
    qi, yi = _pairs(rng, 6, 40, 300)
    yi[rng.random(300) < 0.2] = -1                  # NO_NODE reads no row
    t = [torch.from_numpy(a) for a in (vecs, x, qi, yi)]
    got = ops.gather_sq_dists_pairs(*t)
    want = np.asarray(jops.gather_sq_dists(
        jnp.asarray(vecs), jnp.asarray(x[qi]), jnp.asarray(yi[:, None]),
        impl="ref"))[:, 0]
    assert torch.equal(torch.isinf(got), torch.from_numpy(yi < 0))
    _close(got[yi >= 0], want[yi >= 0])
    # the plain version is the composition the re-rank ran before
    assert torch.equal(got, ops.gather_sq_dists(
        t[0], t[1][t[2].long()], t[3][:, None])[:, 0])


@pytest.mark.parametrize("gs", [128, 64, 12])
@pytest.mark.parametrize("d", DIMS)
def test_int8_pair_entry_matches_the_reference(d, gs):
    st, jst, qc, _ = _carried_int8(50, d, gs, 7, "pairs")
    rng = _rng("i8pairs", d, gs)
    qi, yi = _pairs(rng, 7, 50, 200)
    got = ref.gather_sq_dists_int8_pairs(st.q, qc.q, torch.from_numpy(qi),
                                         torch.from_numpy(yi), st.scales,
                                         group_size=gs)
    jqx = jnp.asarray(qc.q.numpy())
    want = np.asarray(jops.rowwise_sq_dists_int8(
        jqx[qi], jst.q[yi][:, None], jst.scales, group_size=gs, impl="ref"))
    _close(got, want[:, 0], rtol=1e-5)
    # bit for bit the (B, K) entry over a copy of the query rows, a (P, 1)
    # id column: the composition the NLJ's escalation ran before
    assert torch.equal(got, ops.gather_sq_dists_int8(
        st.q, qc.q[qi], torch.from_numpy(yi[:, None]), st.scales,
        group_size=gs)[:, 0])


def test_pair_entries_give_inf_out_of_range_and_take_empty_lists():
    rng = _rng("edge")
    vecs = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    qi = torch.tensor([0, 2, 3, -1, 1], dtype=torch.int32)
    yi = torch.tensor([4, 5, 0, 0, -1], dtype=torch.int32)
    got = ops.gather_sq_dists_pairs(vecs, x, qi, yi)
    assert torch.equal(torch.isinf(got),
                       torch.tensor([False, True, True, True, True]))
    qs = QuantStore(q=torch.zeros(5, 8, dtype=torch.int8),
                    scales=torch.ones(1), norms=torch.zeros(5),
                    err=torch.zeros(5), group_size=128)
    qx = torch.zeros(3, 8, dtype=torch.int8)
    d8 = ref.gather_sq_dists_int8_pairs(qs.q, qx, qi, yi, qs.scales)
    lb, ub = ops.gather_bounds_int8_pairs(qs.q, qx, qi, yi, qs.scales,
                                          err=qs.err, qerr=torch.zeros(3))
    for v in (d8, lb, ub):
        assert torch.equal(torch.isinf(v), torch.isinf(got))
    e = torch.zeros(0, dtype=torch.int32)
    assert ops.gather_sq_dists_pairs(vecs, x, e, e).shape == (0,)
    assert all(v.shape == (0,) for v in ops.gather_bounds_int8_pairs(
        qs.q, qx, e, e, qs.scales, err=qs.err, qerr=torch.zeros(3)))


# -- the int8 tier's gather bounds (#7') -------------------------------------

@pytest.mark.parametrize("B,K", LANES)
@pytest.mark.parametrize("gs", [128, 64, 12])
@pytest.mark.parametrize("d", DIMS)
def test_int8_gather_bounds_match_the_reference_tier(d, gs, B, K):
    st, jst, qc, jq = _carried_int8(60, d, gs, B, "gb")
    cand = _ids(_rng("gbids", d, gs, B, K), B, K, 60)
    lb, ub, est = Int8Tier(st).gather_bounds(qc, torch.from_numpy(cand),
                                             impl=None)
    assert est is None and lb.shape == ub.shape == (B, K)
    valid = cand >= 0
    assert bool(torch.isinf(lb[~valid]).all() and torch.isinf(ub[~valid])
                .all())
    jlb, jub, _ = jcascade.Int8Tier(jst).gather_bounds(
        jq, jnp.asarray(np.where(valid, cand, 0)), impl="ref")
    for got, want in ((lb, jlb), (ub, jub)):
        _close(got[valid], np.asarray(want)[valid], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,K", LANES)
@pytest.mark.parametrize("d", DIMS)
def test_int8_gather_bounds_on_the_cpu_are_the_composition(d, B, K):
    """Bit for bit the eager composition ``Int8Tier.gather_bounds`` ran
    before the fused entry: d̂ of the int8 gather, slack ``qerr[b] +
    err[id]``, then ``quant_lower_bound`` / ``quant_upper_bound``."""
    st, _, qc, _ = _carried_int8(60, d, 128, B, "comp")
    cand = torch.from_numpy(_ids(_rng("compids", d, B, K), B, K, 60))
    lb, ub, _ = Int8Tier(st).gather_bounds(qc, cand, impl="ref")
    dhat = ops.gather_sq_dists_int8(st.q, qc.q, cand, st.scales)
    slack = qc.err[:, None] + st.err[cand.clamp_min(0).long()]
    assert torch.equal(lb, ops.quant_lower_bound(dhat, slack))
    assert torch.equal(ub, ops.quant_upper_bound(dhat, slack))


@pytest.mark.parametrize("d", DIMS)
def test_int8_pair_refine_matches_the_reference_tier(d):
    st, jst, qc, jq = _carried_int8(60, d, 128, 8, "refine")
    qi, yi = _pairs(_rng("refids", d), 8, 60, 250)
    lb, ub = Int8Tier(st).pair_refine(qc, torch.from_numpy(qi).long(),
                                      torch.from_numpy(yi).long())
    jlb, jub = jcascade.Int8Tier(jst).pair_refine(jq, jnp.asarray(qi),
                                                  jnp.asarray(yi))
    _close(lb, jlb, rtol=1e-5, atol=1e-5)
    _close(ub, jub, rtol=1e-5, atol=1e-5)
    # bit for bit the composition it replaced: the (P, 1) id column over
    # a copy of the pairs' query rows, then the bounds
    dhat = ops.gather_sq_dists_int8(
        st.q, qc.q[qi], torch.from_numpy(yi[:, None]), st.scales)[:, 0]
    slack = qc.err[qi] + st.err[yi]
    assert torch.equal(lb, ops.quant_lower_bound(dhat, slack))
    assert torch.equal(ub, ops.quant_upper_bound(dhat, slack))


@pytest.mark.parametrize("d", [33, 128, 150])
def test_pdx_gather_bounds_and_pair_refine_match_the_reference_tier(d):
    """The PDX tier's gather bounds and pair refinement (a 64-dim slab as
    the group) against the reference's tier on a carried store."""
    st, jst, qc, jq = _carried_pdx(80, d, 6, "tier")
    rng = _rng("pdxids", d)
    cand = _ids(rng, 6, 20, 80)
    valid = cand >= 0
    lb, ub, _ = PdxTier(st).gather_bounds(qc, torch.from_numpy(cand),
                                          impl=None)
    assert bool(torch.isinf(lb[~valid]).all() and torch.isinf(ub[~valid])
                .all())
    jlb, jub, _ = jcascade.PdxTier(jst).gather_bounds(
        jq, jnp.asarray(np.where(valid, cand, 0)), impl="ref")
    _close(lb[valid], np.asarray(jlb)[valid], rtol=1e-5, atol=1e-5)
    _close(ub[valid], np.asarray(jub)[valid], rtol=1e-5, atol=1e-5)
    qi, yi = _pairs(rng, 6, 80, 150)
    plb, pub = PdxTier(st).pair_refine(qc, torch.from_numpy(qi),
                                       torch.from_numpy(yi))
    jplb, jpub = jcascade.PdxTier(jst).pair_refine(jq, jnp.asarray(qi),
                                                   jnp.asarray(yi))
    _close(plb, jplb, rtol=1e-5, atol=1e-5)
    _close(pub, jpub, rtol=1e-5, atol=1e-5)
    # the pair list's bounds are the (B, K) entry's for the same pairs
    ids = torch.from_numpy(yi).reshape(-1, 1)
    glb, gub = ops.gather_bounds_int8(st.q, qc.q[qi], ids, st.scales,
                                      err=st.err, qerr=qc.err[qi],
                                      group_size=st.slab)
    assert torch.equal(plb, glb[:, 0]) and torch.equal(pub, gub[:, 0])


def test_gather_entries_run_their_plain_versions_on_the_cpu():
    st, _, qc, _ = _carried_int8(10, 16, 128, 3, "entry")
    cand = torch.zeros(3, 2, dtype=torch.int32)
    qi = yi = torch.zeros(4, dtype=torch.int32)
    n0 = ops.launch_counts()
    for fn in (lambda impl: ops.gather_bounds_int8(
                   st.q, qc.q, cand, st.scales, err=st.err, qerr=qc.err,
                   impl=impl),
               lambda impl: ops.gather_bounds_int8_pairs(
                   st.q, qc.q, qi, yi, st.scales, err=st.err, qerr=qc.err,
                   impl=impl),
               lambda impl: ops.gather_sq_dists_pairs(
                   st.q.float(), qc.q.float(), qi, yi, impl=impl)):
        fn(None)
        with pytest.raises(ValueError, match="CPU tensors"):
            fn("cuda")                                    # no fallback
    assert ops.launch_counts() == n0                      # no kernel
    lb, ub = ops.gather_bounds_int8(st.q, qc.q, cand, st.scales, err=st.err,
                                    qerr=qc.err)
    wlb, wub = ref.gather_bounds_int8(st.q, qc.q, cand, st.scales, st.err,
                                      qc.err)
    assert torch.equal(lb, wlb) and torch.equal(ub, wub)
    assert bool((lb <= ub).all())
