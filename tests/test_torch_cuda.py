"""The port's CUDA kernels and its join on the card (``cuda`` marker).

These run only where a CUDA device is visible and skip elsewhere. The file
imports neither JAX nor ``repro``, so on a machine with a card and without
JAX it runs as

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same inputs
(pairwise ``atol = 1e-5·(‖x‖²+‖y‖²)``, ``rtol = 1e-5``; rowwise and gather
``rtol = 1e-6``, ``atol = 1e-6·max d``; int8 pairwise ``|Δ| ≤
1e-5·(xn+yn) + 1e-6``, int8 rowwise and gather ``|Δ| ≤ 1e-5·value +
1e-6`` — the plain versions dequantize first; the top-k merge exactly, ids
and tie order included; the pair list bit-equal to the pairwise kernel),
and the joins on the card against the same joins on the CPU over one
index, in f32 and under sq8.
"""
import dataclasses
import zlib

import numpy as np
import pytest
import torch

from repro_torch.core import JoinConfig, build_index, exact_join_pairs
from repro_torch.core.types import GraphIndex, pair_keys
from repro_torch.data.vectors import make_dataset, thresholds
from repro_torch.engine import JoinEngine
from repro_torch.kernels import ops, ref
from repro_torch.quant import build_store, quantize_queries

pytestmark = pytest.mark.cuda

PAIRWISE_SHAPES = [(1, 1, 1), (3, 5, 7), (9, 130, 33), (300, 1000, 128),
                   (0, 4, 8), (4, 0, 8), (5, 7, 0)]
ROW_SHAPES = [(1, 1, 1), (3, 5, 7), (9, 33, 130), (256, 128, 128),
              (0, 4, 8), (3, 0, 8), (5, 3, 0)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _close_rows(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    assert torch.equal(got.isfinite(), want.isfinite())
    fin = want.isfinite()
    if fin.any():
        g, w = got[fin], want[fin]
        assert bool(((g - w).abs() <= 1e-6 * w.abs() + 1e-6 * w.abs().max())
                    .all())


@pytest.mark.parametrize("B,N,d", PAIRWISE_SHAPES)
def test_pairwise_kernel_matches_plain(dev, B, N, d):
    rng = _rng("pw", B, N, d)
    x = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(N, d)).astype(np.float32))
    n0 = ops.launch_counts()["pairwise_sq_dists"]
    got = ops.pairwise_sq_dists(x.to(dev), y.to(dev))
    torch.cuda.synchronize()
    assert ops.launch_counts()["pairwise_sq_dists"] == n0 + (B * N * d > 0)
    want = ref.pairwise_sq_dists(x, y).double()
    tol = (1e-5 * (ref.sq_norms(x)[:, None] + ref.sq_norms(y)[None, :])
           + 1e-5 * want.abs())
    assert got.shape == want.shape
    assert bool(((got.double().cpu() - want).abs() <= tol).all())


@pytest.mark.parametrize("B,K,d", ROW_SHAPES)
def test_row_kernels_match_plain(dev, B, K, d):
    rng = _rng("rw", B, K, d)
    x = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(B, K, d)).astype(np.float32))
    vecs = torch.from_numpy(rng.normal(size=(50, d)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-1, 50, (B, K)).astype(np.int32))
    _close_rows(ops.rowwise_sq_dists(x.to(dev), c.to(dev)),
                ref.rowwise_sq_dists(x, c))
    _close_rows(ops.gather_sq_dists(vecs.to(dev), x.to(dev), idx.to(dev)),
                ref.gather_sq_dists(vecs, x, idx))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros(4, 8, device=dev)
    with pytest.raises(TypeError):
        ops.pairwise_sq_dists(x.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.pairwise_sq_dists(x.t(), x.t())
    with pytest.raises(ValueError, match="on cpu"):
        ops.rowwise_sq_dists(x, x.cpu()[:, None])
    with pytest.raises(TypeError):
        ops.gather_sq_dists(x, x, torch.zeros(4, 2, dtype=torch.int64,
                                              device=dev))
    with pytest.raises(ValueError, match="CPU tensors"):   # no fallback
        ops.pairwise_sq_dists(x, x, impl="ref")


def _to(index: GraphIndex, dev) -> GraphIndex:
    return dataclasses.replace(
        index, vecs=index.vecs.to(dev), nbrs=index.nbrs.to(dev),
        start=index.start.to(dev), mean_nbr_dist=index.mean_nbr_dist.to(dev))


@pytest.mark.parametrize("regime", ["manifold", "ood"])
def test_join_on_the_card_matches_the_cpu(dev, regime):
    ds = make_dataset(regime, n_data=1500, n_query=96, dim=32, seed=3)
    d2 = np.sort(((ds.X.astype(np.float64)[:, None]
                   - ds.Y.astype(np.float64)[None]) ** 2).sum(-1), axis=None)
    theta = float(thresholds(ds, 3)[1])
    i = np.searchsorted(d2, theta ** 2)
    theta = float(np.sqrt(0.5 * (d2[i - 1] + d2[i])))   # mid-gap: no ties
    cpu = torch.device("cpu")
    merged = build_index(np.concatenate([ds.Y, ds.X]), k=24, degree=12,
                         n_data=1500, device=cpu)
    cfg = JoinConfig(theta=theta, wave_size=32)
    want = JoinEngine(ds.Y, default=cfg, device=cpu).join(
        ds.X, index_merged=merged)
    ops.reset_launch_counts()
    got = JoinEngine(ds.Y, default=cfg, device=dev).join(
        ds.X, index_merged=_to(merged, dev))
    assert ops.launch_counts()["gather_sq_dists"] > 0
    np.testing.assert_array_equal(pair_keys(got.pairs, 1500),
                                  pair_keys(want.pairs, 1500))
    for f in ("n_dist", "n_iters", "n_ood", "n_overflow"):
        assert getattr(got.stats, f) == getattr(want.stats, f), f


def test_build_and_nlj_on_the_card(dev):
    ds = make_dataset("manifold", n_data=3000, n_query=64, dim=24, seed=5)
    theta = float(thresholds(ds, 7)[2])
    ops.reset_launch_counts()
    eng = JoinEngine(ds.Y, build_kw=dict(k=24, degree=12), device=dev)
    res = eng.join(ds.X, JoinConfig(theta=theta))
    counts = ops.launch_counts()
    for k in ("pairwise_sq_dists", "rowwise_sq_dists", "gather_sq_dists",
              "topk_merge"):                       # the f32 path's kernels
        assert counts[k] > 0, counts
    assert eng.merged_index(ds.X).nbrs.device.type == "cuda"
    truth = exact_join_pairs(ds.X, eng.Y, theta)
    found, t = pair_keys(res.pairs, 3000), pair_keys(truth, 3000)
    assert np.setdiff1d(found, t).size == 0                     # sound
    assert np.intersect1d(found, t).size >= 0.9 * t.size        # recall


INT8_DIMS = [64, 128, 200]


@pytest.mark.parametrize("d", INT8_DIMS)
@pytest.mark.parametrize("B,N", [(1, 1), (37, 300), (256, 1000), (0, 5),
                                 (5, 0)])
def test_int8_pairwise_kernel_matches_plain(dev, B, N, d):
    rng = _rng("i8pw", B, N, d)
    y = torch.from_numpy(rng.normal(size=(max(N, 1), d)).astype(np.float32))
    st = build_store(y.to(dev))
    qy, yn = st.q[:N], st.norms[:N]
    x = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32))
    qx, xn, _ = quantize_queries(x.to(dev), st)
    n0 = ops.launch_counts()["pairwise_sq_dists_int8"]
    got = ops.pairwise_sq_dists_int8(qx, qy, st.scales, xn=xn, yn=yn)
    torch.cuda.synchronize()
    assert ops.launch_counts()["pairwise_sq_dists_int8"] == n0 + (B * N > 0)
    want = ref.pairwise_sq_dists_int8(qx.cpu(), qy.cpu(), st.scales.cpu())
    assert got.shape == want.shape
    tol = 1e-5 * (xn.cpu()[:, None] + yn.cpu()[None, :]) + 1e-6
    assert bool(((got.cpu() - want).abs() <= tol).all())


@pytest.mark.parametrize("d", INT8_DIMS)
@pytest.mark.parametrize("B,K", [(1, 1), (33, 65), (256, 128), (0, 4),
                                 (3, 0)])
def test_int8_rowwise_and_gather_kernels_match_plain(dev, B, K, d):
    rng = _rng("i8rw", B, K, d)
    st = build_store(torch.from_numpy(
        rng.normal(size=(60, d)).astype(np.float32)).to(dev))
    qx = quantize_queries(torch.from_numpy(
        rng.normal(size=(B, d)).astype(np.float32)).to(dev), st)[0]
    idx = rng.integers(0, 60, (B, K)).astype(np.int32)
    idx[rng.random((B, K)) < 0.5] = -1          # NO_NODE reads no row
    idx = torch.from_numpy(idx)
    cands = st.q[idx.clamp_min(0).long().to(dev)]
    for got, want in (
            (ops.rowwise_sq_dists_int8(qx, cands, st.scales),
             ref.rowwise_sq_dists_int8(qx.cpu(), cands.cpu(),
                                       st.scales.cpu())),
            (ops.gather_sq_dists_int8(st.q, qx, idx.to(dev), st.scales),
             ref.gather_sq_dists_int8(st.q.cpu(), qx.cpu(), idx,
                                      st.scales.cpu()))):
        got = got.cpu()
        assert got.shape == want.shape
        assert torch.equal(got.isfinite(), want.isfinite())
        fin = want.isfinite()
        assert bool(((got[fin] - want[fin]).abs()
                     <= 1e-5 * want[fin].abs() + 1e-6).all())


@pytest.mark.parametrize("B,L,K", [(1, 1, 1), (7, 5, 13), (64, 48, 48),
                                   (9, 200, 300), (0, 4, 4), (5, 4, 0)])
def test_topk_merge_kernel_matches_plain_with_ties(dev, B, L, K):
    rng = _rng("topk", B, L, K)
    bd = np.sort(rng.integers(0, 6, (B, L)).astype(np.float32), axis=1)
    bd[:, L - 1:] = np.inf
    cd = rng.integers(0, 6, (B, K)).astype(np.float32)
    cd[rng.random((B, K)) < 0.1] = np.inf
    bi = rng.integers(0, 1 << 30, (B, L)).astype(np.int32)
    ci = rng.integers(0, 1 << 30, (B, K)).astype(np.int32)
    args = [torch.from_numpy(a) for a in (bd, bi, cd, ci)]
    gd, gi = ops.topk_merge(*(a.to(dev) for a in args))
    wd, wi = ref.topk_merge(*args)
    assert torch.equal(gd.cpu(), wd) and torch.equal(gi.cpu(), wi)


@pytest.mark.parametrize("B,N,d", [(3, 5, 7), (129, 257, 33),
                                   (300, 1000, 128), (64, 500, 200)])
def test_pairlist_equals_the_pairwise_kernel(dev, B, N, d):
    rng = _rng("pl", B, N, d)
    x = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.normal(size=(N, d)).astype(np.float32)).to(dev)
    xn, yn = ref.sq_norms(x), ref.sq_norms(y)
    full = ops.pairwise_sq_dists(x, y, xn=xn, yn=yn)
    qi = torch.from_numpy(rng.integers(0, B, 5000).astype(np.int32)).to(dev)
    yi = torch.from_numpy(rng.integers(0, N, 5000).astype(np.int32)).to(dev)
    got = ops.pairlist_sq_dists(x, y, qi, yi, xn=xn, yn=yn)
    assert torch.equal(got, full[qi.long(), yi.long()])
    bad = ops.pairlist_sq_dists(x, y, qi[:2] * 0 - 1, yi[:2], xn=xn, yn=yn)
    assert bool(torch.isinf(bad).all())


@pytest.mark.parametrize("regime", ["manifold", "ood"])
def test_sq8_join_on_the_card_matches_the_cpu(dev, regime):
    ds = make_dataset(regime, n_data=1500, n_query=96, dim=32, seed=3)
    d2 = np.sort(((ds.X.astype(np.float64)[:, None]
                   - ds.Y.astype(np.float64)[None]) ** 2).sum(-1), axis=None)
    theta = float(thresholds(ds, 3)[1])
    i = np.searchsorted(d2, theta ** 2)
    theta = float(np.sqrt(0.5 * (d2[i - 1] + d2[i])))   # mid-gap: no ties
    cpu = torch.device("cpu")
    merged = build_index(np.concatenate([ds.Y, ds.X]), k=24, degree=12,
                         n_data=1500, device=cpu)
    cfg = JoinConfig(theta=theta, wave_size=32, quant="sq8")
    want = JoinEngine(ds.Y, default=cfg, device=cpu).join(
        ds.X, index_merged=merged)
    ops.reset_launch_counts()
    got = JoinEngine(ds.Y, default=cfg, device=dev).join(
        ds.X, index_merged=_to(merged, dev))
    counts = ops.launch_counts()
    assert counts["rowwise_sq_dists_int8"] > 0 and counts["gather_sq_dists"] > 0
    np.testing.assert_array_equal(pair_keys(got.pairs, 1500),
                                  pair_keys(want.pairs, 1500))
    for f in ("n_dist", "n_iters", "n_ood", "n_rerank"):
        assert getattr(got.stats, f) == getattr(want.stats, f), f


def test_sq8_build_and_nlj_on_the_card(dev):
    ds = make_dataset("manifold", n_data=3000, n_query=64, dim=24, seed=5)
    theta = float(thresholds(ds, 7)[2])
    ops.reset_launch_counts()
    eng = JoinEngine(ds.Y, build_kw=dict(k=24, degree=12, quant="sq8"),
                     default=JoinConfig(theta=theta, quant="sq8"),
                     device=dev)
    res = eng.join(ds.X)
    counts = ops.launch_counts()
    for k in ("pairwise_sq_dists_int8", "rowwise_sq_dists_int8",
              "topk_merge", "pairlist_sq_dists", "gather_sq_dists"):
        assert counts[k] > 0, k
    f32 = build_index(np.concatenate([ds.Y, ds.X]), k=24, degree=12,
                      n_data=3000, device=dev)
    assert torch.equal(eng.merged_index(ds.X).nbrs, f32.nbrs)
    truth = exact_join_pairs(ds.X, eng.Y, theta)
    found, t = pair_keys(res.pairs, 3000), pair_keys(truth, 3000)
    assert np.setdiff1d(found, t).size == 0                     # sound
    nlj = eng.join(ds.X, method="nlj")
    np.testing.assert_array_equal(pair_keys(nlj.pairs, 3000), t)
