"""The port's CUDA kernels and its join on the card (``cuda`` marker).

These run only where a CUDA device is visible and skip elsewhere. The file
imports neither JAX nor ``repro``, so on a machine with a card and without
JAX it runs as

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same inputs
(pairwise ``atol = 1e-5·(‖x‖²+‖y‖²)``, ``rtol = 1e-5``; rowwise and gather
``rtol = 1e-6``, ``atol = 1e-6·max d``; int8 pairwise ``|Δ| ≤
1e-5·(xn+yn) + 1e-6``, int8 rowwise and gather ``|Δ| ≤ 1e-5·value +
1e-6`` — the plain versions dequantize first; the int8 pairwise kernel
also bit for bit against ``ref.pairwise_sq_dists_int8_exact``, its own
arithmetic, and the fused int8 bounds kernel bit for bit against the
torch composition over the pairwise kernel's d̂; the top-k merge exactly,
ids and tie order included; the pair list bit-equal to the pairwise
kernel, also at shapes that cross the f32 tile's and its pipeline's
edges and from an unaligned base),
the f32 gather bit for bit against the rowwise kernel over the gathered
rows (the two share each lane's slots, fmaf chain and xor-tree) and its
pair-list entry against it, from aligned and unaligned bases; the int8
gather bit for bit against ``ref.gather_sq_dists_int8_exact`` (its own
arithmetic), its pair list against it and the fused int8 gather bounds
(both entries, through ``Int8Tier``/``PdxTier``) against the torch
composition over its d̂; the Hamming kernels exactly, and the fused sketch
gather bounds (#9′) bit for bit the torch composition it replaced, run on
the card; the PDX kernels with early exit off within
``|Δ| ≤ 1e-6·value + 1e-6·(xn+yn)`` (pairwise; the plain version repeats
its operation order) and ``rtol = 1e-6``, ``atol = 1e-6·max d`` (gather),
survivors bit-identical with early exit on and off, the pairwise slab
counts equal to the plain version's; and, run on the card, the PDX
pairwise kernel bit for bit its plain version and its fused bounds entry
bit for bit ``ref.int8_bounds`` over its d̂, at slabs that are not a
multiple of 32, ragged tiles, unaligned code bases, a query tile too deep
for shared memory and thresholds where all, some or no lanes retire; the
top-k merge on both of its routes), the fused PDX band re-rank (#11′) bit
for bit the band compaction, the PDX gather kernel and the scatter it
replaced, the NLJ count exactly (against the
plain version at a θ clear of boundary pairs, and against the pairwise
kernel's distances at any θ), and the joins on the card against the same
joins on the CPU over the same indexes (and, under the sketch and PDX
modes, over the CPU engine's stores): the merged-index join in f32, under
sq8, sketch8, pdx8 and sketchpdx8, and the search path's caching methods;
and the streaming engine's int8 parents through #6 (bit for bit its own
arithmetic on the padded carry window; the CPU engine's parents but for
near-ties) and ``sketch_survivors`` through #8 (the plain Hamming
counts' masks); and the sharded joins on a ``DeviceMesh`` of the card
twice (the mesh MI join in f32 and sq8, the mesh NLJ) against the same
calls on a CPU mesh. The gather's bf16 entry within the gather's
tolerance of its plain version and of the JAX package's kept output; its
custom op (``repro_torch::gather_sq_dists``) bit for bit the direct
launch; a separated iteration of the mesh MI join counted on the card =
the FLOPs of the dry run's trace of the same shapes; the 2-D-sharded NLJ count = #5's. The LM serving path: every smoke config's forward,
prefill and ragged decode in f32 on the card against the CPU within
rtol = atol = 1e-4, and ``ServeEngine`` on the card giving the CPU's
greedy tokens.
"""
import copy
import dataclasses
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get as arch_spec
from repro_torch.core import JoinConfig, build_index, exact_join_pairs
from repro_torch.core.graph import BuildStats
from repro_torch.core.types import GraphIndex, pair_keys
from repro_torch.data.vectors import make_dataset, thresholds
from repro_torch.engine import JoinEngine
from repro_torch.kernels import ops, ref
from repro_torch.models import model as LM
from repro_torch.quant import build_store, dequantize, quantize_queries
from repro_torch.quant.cascade import MATMUL_GUARD, Int8Queries, Int8Tier

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


@pytest.mark.parametrize("L", [1, 48, 64, 65, 200])
@pytest.mark.parametrize("K", [0, 1, 48, 64, 65, 300])
def test_topk_merge_both_routes_match_plain(dev, L, K):
    """L and K up to 64 take the warp-per-row kernel, wider rows the
    block-per-row kernel (chosen by shape): both equal the plain version,
    with rows all tied, rows of +inf, NO_NODE ids and unaligned rows."""
    rng = _rng("topk2", L, K)
    B = 37
    bd = np.sort(rng.integers(0, 4, (B, L)).astype(np.float32), axis=1)
    cd = rng.integers(0, 4, (B, K)).astype(np.float32)
    bd[0], cd[0] = 2.0, 2.0                     # a row all tied
    bd[1], cd[1] = np.inf, np.inf               # a row of +inf
    bd[2, L // 2:] = np.inf
    cd[3, ::3] = np.inf
    bi = rng.integers(0, 1 << 30, (B, L)).astype(np.int32)
    ci = rng.integers(0, 1 << 30, (B, K)).astype(np.int32)
    ci[rng.random((B, K)) < 0.2] = -1           # NO_NODE candidates
    args = [torch.from_numpy(a) for a in (bd, bi, cd, ci)]
    wd, wi = ref.topk_merge(*args)
    gd, gi = ops.topk_merge(*(a.to(dev) for a in args))
    assert torch.equal(gd.cpu(), wd) and torch.equal(gi.cpu(), wi)
    # from bases 4 bytes past a 16-byte boundary: the scalar loads
    gd, gi = ops.topk_merge(*(_unaligned(a.to(dev)) for a in args))
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


# B and N around the 128-wide tile (1, 127, 129, 4097) and d around the
# 8/16-deep slices and 16-byte loads
TILE_EDGES = [(1, 1), (127, 129), (129, 127), (4097, 129), (129, 4097),
              (1, 4097), (4097, 1)]


def _unaligned(a):
    """``a``'s values in a contiguous view whose base is 4 bytes past a
    16-byte boundary (the kernels' scalar-load path)."""
    n, d = a.shape
    buf = torch.empty(n * d + 1, dtype=a.dtype, device=a.device)
    buf[1:] = a.reshape(-1)
    return buf[1:].view(n, d)


@pytest.mark.parametrize("d", [1, 3, 33, 127, 128, 130, 256])
@pytest.mark.parametrize("B,N", TILE_EDGES)
def test_f32_tile_edges(dev, B, N, d):
    """The pairwise kernel against its plain version, the pair list bit
    for bit against it and the NLJ count against its counts, at ragged
    tile and slice edges, with y aligned and from an unaligned base."""
    rng = _rng("edge", B, N, d)
    x = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32)).to(dev)
    y0 = torch.from_numpy(rng.normal(size=(N, d)).astype(np.float32)).to(dev)
    xn = ref.sq_norms(x)
    for y in (y0, _unaligned(y0)):
        yn = ref.sq_norms(y)
        got = ops.pairwise_sq_dists(x, y, xn=xn, yn=yn)
        want = ref.pairwise_sq_dists(x, y, xn, yn).double()
        tol = 1e-5 * (xn[:, None] + yn[None, :]).double() + 1e-5 * want.abs()
        assert bool(((got.double() - want).abs() <= tol).all())
        qi = torch.from_numpy(rng.integers(0, B, 3000).astype(np.int32)).to(dev)
        yi = torch.from_numpy(rng.integers(0, N, 3000).astype(np.int32)).to(dev)
        pl = ops.pairlist_sq_dists(x, y, qi, yi, xn=xn, yn=yn)
        assert torch.equal(pl, got[qi.long(), yi.long()])
        theta = float(got.flatten().kthvalue(max(1, got.numel() // 3))
                      .values) ** 0.5
        th2 = ref.sq_theta(theta)
        assert torch.equal(ops.nlj_count(x, y, theta=theta),
                           (got < th2).sum(1, dtype=torch.int32))


@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("d", INT8_DIMS)
@pytest.mark.parametrize("B,N", [(1, 1), (37, 301), (256, 1000), (129, 4097)])
def test_int8_pairwise_kernel_is_exact(dev, B, N, d, gs):
    """The int8 pairwise kernel bit for bit against its own arithmetic
    (``ref.pairwise_sq_dists_int8_exact``), with 16-byte, narrower and
    unaligned code rows."""
    rng = _rng("i8exact", B, N, d, gs)
    st = build_store(torch.from_numpy(
        rng.normal(size=(N, d)).astype(np.float32)).to(dev), group_size=gs)
    qx, xn, _ = quantize_queries(torch.from_numpy(
        rng.normal(size=(B, d)).astype(np.float32)).to(dev), st)
    for qy in (st.q, st.q[1:], _unaligned(st.q)):
        yn = st.norms[:qy.shape[0]]
        n0 = ops.launch_counts()["pairwise_sq_dists_int8"]
        got = ops.pairwise_sq_dists_int8(qx, qy, st.scales, group_size=gs,
                                         xn=xn, yn=yn)
        assert ops.launch_counts()["pairwise_sq_dists_int8"] == n0 + (
            qy.shape[0] > 0)
        want = ref.pairwise_sq_dists_int8_exact(qx, qy, st.scales, xn, yn,
                                                group_size=gs)
        assert torch.equal(got, want)


@pytest.mark.parametrize("d,gs", [(2000, 128), (1999, 64)])
def test_int8_kernels_stream_a_query_tile_too_deep_for_shared_memory(
        dev, d, gs):
    """Past ~1,300 dims the 128-row query tile does not fit in shared
    memory and streams through the ring beside the data tiles: still
    bit for bit the exact plain version and the composition (16-byte and
    byte loads)."""
    rng = _rng("i8deep", d, gs)
    st = build_store(torch.from_numpy(
        rng.normal(size=(301, d)).astype(np.float32)).to(dev), group_size=gs)
    qx, xn, xe = quantize_queries(torch.from_numpy(
        rng.normal(size=(37, d)).astype(np.float32)).to(dev), st)
    got = ops.pairwise_sq_dists_int8(qx, st.q, st.scales, group_size=gs,
                                     xn=xn, yn=st.norms)
    want = ref.pairwise_sq_dists_int8_exact(qx, st.q, st.scales, xn,
                                            st.norms, group_size=gs)
    assert torch.equal(got, want)
    lb, ub = ops.pairwise_bounds_int8(qx, st.q, st.scales, group_size=gs,
                                      xn=xn, yn=st.norms, xe=xe, ye=st.err,
                                      guard=MATMUL_GUARD)
    wlb, wub = ref.int8_bounds(want, xn, st.norms, xe, st.err, MATMUL_GUARD)
    assert torch.equal(lb, wlb) and torch.equal(ub, wub)


@pytest.mark.parametrize("d,gs", [(64, 128), (128, 128), (200, 128),
                                  (200, 64), (100, 32)])
@pytest.mark.parametrize("B,N", [(1, 1), (37, 301), (256, 1000), (0, 5),
                                 (5, 0)])
def test_int8_bounds_kernel_is_the_composition(dev, B, N, d, gs):
    """The fused bounds kernel bit for bit against the torch composition
    over the pairwise kernel's d̂ (and over the exact plain version), and
    ``Int8Tier.pairwise_bounds`` on the card through it."""
    rng = _rng("i8bounds", B, N, d, gs)
    st = build_store(torch.from_numpy(
        rng.normal(size=(max(N, 1), d)).astype(np.float32)).to(dev),
        group_size=gs)
    qy, yn, ye = st.q[:N], st.norms[:N], st.err[:N]
    qx, xn, xe = quantize_queries(torch.from_numpy(
        rng.normal(size=(B, d)).astype(np.float32)).to(dev), st)
    n0 = ops.launch_counts()["pairwise_bounds_int8"]
    lb, ub = ops.pairwise_bounds_int8(qx, qy, st.scales, group_size=gs,
                                      xn=xn, yn=yn, xe=xe, ye=ye,
                                      guard=MATMUL_GUARD)
    assert ops.launch_counts()["pairwise_bounds_int8"] == n0 + (B * N > 0)
    dhat = ops.pairwise_sq_dists_int8(qx, qy, st.scales, group_size=gs,
                                      xn=xn, yn=yn)
    exact = ref.pairwise_sq_dists_int8_exact(qx, qy, st.scales, xn, yn,
                                             group_size=gs)
    for dh in (dhat, exact):
        wlb, wub = ref.int8_bounds(dh, xn, yn, xe, ye, MATMUL_GUARD)
        assert torch.equal(lb, wlb) and torch.equal(ub, wub)
    tier = Int8Tier(st)
    qc = Int8Queries(q=qx, norms=xn, err=xe)
    n0 = ops.launch_counts()["pairwise_bounds_int8"]
    tlb, tub = tier.pairwise_bounds(qc, impl=None, y0=0, y1=N)
    assert ops.launch_counts()["pairwise_bounds_int8"] == n0 + (B * N > 0)
    assert torch.equal(tlb, lb) and torch.equal(tub, ub)


@pytest.mark.parametrize("d", [1, 7, 8, 33, 128, 130, 2048])
@pytest.mark.parametrize("B,K", [(1, 1), (9, 1), (33, 65), (256, 128),
                                 (5, 17), (0, 3)])
def test_gather_bf16_entry_matches_plain(dev, B, K, d):
    """#3's bf16 entry (bf16 rows and queries, f32 sums) within the f32
    gather's tolerance of its plain version, from aligned and unaligned
    bases; one launch a call; NO_NODE +inf."""
    rng = _rng("g3bf", B, K, d)
    vecs = torch.from_numpy(rng.normal(size=(70, d)).astype(np.float32)
                            ).to(dev).bfloat16()
    x = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32)
                         ).to(dev).bfloat16()
    idx = torch.from_numpy(_rng("g3bfids", B, K).integers(
        -1, 70, (B, K)).astype(np.int32)).to(dev)
    n0 = ops.launch_counts()["gather_sq_dists_bf16"]
    got = ops.gather_sq_dists(vecs, x, idx)
    assert ops.launch_counts()["gather_sq_dists_bf16"] == n0 + (B * K > 0)
    assert got.dtype == torch.float32 and got.shape == (B, K)
    _close_rows(got, ref.gather_sq_dists(vecs.cpu(), x.cpu(), idx.cpu()))
    if B * K:
        _close_rows(ops.gather_sq_dists(_unaligned(vecs), _unaligned(x), idx),
                    ref.gather_sq_dists(vecs.cpu(), x.cpu(), idx.cpu()))


@pytest.mark.parametrize("case", range(3))
def test_gather_bf16_entry_matches_jax_reference_output(dev, case):
    """#3's bf16 entry on the card against the JAX package's bf16 gather
    output kept in ``tests/data/gather_bf16_reference.npz`` (the inputs'
    bf16 bits, NO_NODE ids included; ``test_torch_join_dryrun.py`` holds
    the file to the JAX package), within the gather's tolerance; the
    custom op's route bit for bit the direct launch."""
    f = np.load(Path(__file__).parent / "data" / "gather_bf16_reference.npz")
    bf = lambda a: torch.from_numpy(a).view(torch.bfloat16).to(dev)
    vecs, x = bf(f[f"vecs{case}"]), bf(f[f"x{case}"])
    idx = torch.from_numpy(f[f"idx{case}"]).to(dev)
    n0 = ops.launch_counts()["gather_sq_dists_bf16"]
    got = ops.gather_sq_dists(vecs, x, idx)
    assert ops.launch_counts()["gather_sq_dists_bf16"] == n0 + 1
    _close_rows(got, torch.from_numpy(f[f"want{case}"]))
    assert torch.equal(torch.ops.repro_torch.gather_sq_dists(vecs, x, idx),
                       got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_custom_op_is_the_direct_launch(dev, dtype):
    """``repro_torch::gather_sq_dists`` on CUDA tensors launches #3 (or its
    bf16 entry): bit for bit the direct launch, one launch a call; under a
    dispatch mode (the cost counter) the wrapper takes the op."""
    from repro_torch.roofline.cost import CostCounter
    rng = _rng("g3op", dtype)
    vecs = torch.from_numpy(rng.normal(size=(5000, 128)).astype(np.float32)
                            ).to(dev, dtype)
    x = torch.from_numpy(rng.normal(size=(256, 128)).astype(np.float32)
                         ).to(dev, dtype)
    idx = torch.from_numpy(rng.integers(-1, 5000, (256, 128)).astype(
        np.int32)).to(dev)
    key = "gather_sq_dists" if dtype == torch.float32 else \
        "gather_sq_dists_bf16"
    direct = ops.gather_sq_dists(vecs, x, idx)
    n0 = ops.launch_counts()[key]
    via = torch.ops.repro_torch.gather_sq_dists(vecs, x, idx)
    assert ops.launch_counts()[key] == n0 + 1
    assert torch.equal(via, direct)
    cc = CostCounter()
    with cc:
        counted = ops.gather_sq_dists(vecs, x, idx)
    assert ops.launch_counts()[key] == n0 + 2
    assert torch.equal(counted, direct)
    assert cc.flops == 3 * 256 * 128 * 128


def test_separated_iteration_on_the_card_counts_the_fake_trace(dev):
    """One separated iteration of the mesh MI join (2 shards on the card,
    f32 and bf16 vectors) under the cost counter: twice the FLOPs of the
    dry run's trace of one shard of the same shapes
    (``launch.dryrun.trace_join_wave``), #3 (or its bf16 entry) launched;
    the f32 iteration's kept ids = the same iteration on the CPU."""
    from repro_torch.configs.vectorjoin import JoinCell
    from repro_torch.core import distributed as D
    from repro_torch.core.types import TraversalConfig
    from repro_torch.launch import dryrun
    from repro_torch.roofline.cost import CostCounter

    ds = make_dataset("manifold", n_data=1501, n_query=96, dim=32, seed=3)
    d2 = np.sort(((ds.X.astype(np.float64)[:, None]
                   - ds.Y.astype(np.float64)[None]) ** 2).sum(-1), axis=None)
    i = np.searchsorted(d2, float(thresholds(ds, 3)[1]) ** 2)
    theta = float(np.sqrt(0.5 * (d2[i - 1] + d2[i])))   # mid-gap: no ties
    cpu = torch.device("cpu")
    smi = D.build_sharded_merged_index(ds.Y, ds.X, 2, devices=(cpu, cpu),
                                       k=24, degree=12)
    cfg = TraversalConfig(pool_cap=128)
    B = 48
    for dt, key in ((torch.float32, "gather_sq_dists"),
                    (torch.bfloat16, "gather_sq_dists_bf16")):
        card = D.ShardedMergedIndex(
            shards=tuple(dataclasses.replace(_to(g, dev),
                                             vecs=g.vecs.to(dev, dt))
                         for g in smi.shards),
            shard_size=smi.shard_size, n_query=smi.n_query)
        x = torch.from_numpy(ds.X[:B]).to(dev, dt)
        qids = torch.arange(B, dtype=torch.int32, device=dev)
        lv = torch.ones(B, dtype=torch.bool, device=dev)
        kw = dict(theta=theta, cfg=cfg)
        cell = JoinCell("card", n_query=smi.n_query,
                        n_data=2 * smi.shard_size, dim=x.shape[1],
                        degree=smi.shards[0].degree, wave_size=B,
                        pool_cap=cfg.pool_cap, max_iters=cfg.max_iters,
                        dtype=str(dt).removeprefix("torch."))
        fake, _ = dryrun.trace_join_wave(cell, n_shards=2, device=dev.type)
        n0 = ops.launch_counts()[key]
        with CostCounter() as real:
            D.mesh_mi_iteration(card, x, qids, lv, **kw)
        torch.cuda.synchronize()
        assert ops.launch_counts()[key] > n0
        assert real.flops == 2 * fake.flops > 0
        if dt == torch.float32:
            got = D.mesh_mi_iteration(card, x, qids, lv, **kw)
            want = D.mesh_mi_iteration(smi, x.cpu(), qids.cpu(), lv.cpu(),
                                       **kw)
            assert torch.equal(got.cpu(), want)


def test_nlj_count_2d_on_the_card_equals_nlj_count(dev):
    """``make_distributed_nlj_count`` on a (2, 2) mesh of logical shards of
    the card = #5's counts, at a θ in a gap of the distances."""
    from repro_torch.core import distributed as D
    rng = _rng("nlj2d")
    X = torch.from_numpy(rng.normal(size=(300, 64)).astype(np.float32)).to(dev)
    Y = torch.from_numpy(rng.normal(size=(5000, 64)).astype(np.float32)
                         ).to(dev)
    d = torch.cdist(X.double(), Y.double()).flatten().sort().values
    i = d.numel() // 100
    i += int(torch.argmax(d[i + 1:i + 200] - d[i:i + 199]))
    theta = float((d[i] + d[i + 1]) / 2)
    mesh = D.DeviceMesh.on_device(dev, 4, (2, 2), ("data", "model"))
    got = D.make_distributed_nlj_count(mesh, "data", "model",
                                       theta=theta)(X, Y)
    n0 = ops.launch_counts()["nlj_count"]
    want = ops.nlj_count(X, Y, theta=theta)
    assert ops.launch_counts()["nlj_count"] == n0 + 1
    assert torch.equal(got, want) and int(got.sum()) > 0


def _pair_list(idx):
    B, K = idx.shape
    qi = torch.arange(B, device=idx.device, dtype=torch.int32)
    return qi.repeat_interleave(K), idx.reshape(-1).contiguous()


@pytest.mark.parametrize("d", [1, 7, 33, 128, 130, 256])
@pytest.mark.parametrize("B,K", [(1, 1), (9, 1), (33, 65), (256, 128),
                                 (5, 17)])
def test_gather_kernel_is_the_rowwise_kernels_arithmetic(dev, B, K, d):
    """The f32 gather (#3) bit for bit against the rowwise kernel (#2) over
    the gathered rows, its pair-list entry bit for bit against it (also
    from unaligned bases), both within tolerance of the plain version, and
    NO_NODE +inf."""
    rng = _rng("g3", B, K, d)
    vecs = torch.from_numpy(rng.normal(size=(70, d)).astype(np.float32)
                            ).to(dev)
    x = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32)).to(dev)
    idx = _rng("g3ids", B, K).integers(-1, 70, (B, K)).astype(np.int32)
    idx = torch.from_numpy(idx).to(dev)
    valid = idx >= 0
    n0 = ops.launch_counts()
    got = ops.gather_sq_dists(vecs, x, idx)
    rw = ops.rowwise_sq_dists(x, vecs[idx.clamp_min(0).long()])
    assert torch.equal(got, torch.where(valid, rw, torch.inf))
    qi, yi = _pair_list(idx)
    assert torch.equal(ops.gather_sq_dists_pairs(vecs, x, qi, yi),
                       got.reshape(-1))
    n1 = ops.launch_counts()
    assert n1["gather_sq_dists"] == n0["gather_sq_dists"] + 1
    assert n1["gather_sq_dists_pairs"] == n0["gather_sq_dists_pairs"] + 1
    _close_rows(got, ref.gather_sq_dists(vecs.cpu(), x.cpu(), idx.cpu()))
    uv, ux = _unaligned(vecs), _unaligned(x)
    ug = ops.gather_sq_dists(uv, ux, idx)
    assert torch.equal(ops.gather_sq_dists_pairs(uv, ux, qi, yi),
                       ug.reshape(-1))
    _close_rows(ug, ref.gather_sq_dists(vecs.cpu(), x.cpu(), idx.cpu()))


@pytest.mark.parametrize("gs", [128, 64, 32, 12, 7])
@pytest.mark.parametrize("d", [1, 7, 33] + INT8_DIMS)
@pytest.mark.parametrize("B,K", [(1, 1), (9, 1), (33, 65), (256, 128)])
def test_int8_gather_kernels_are_exact(dev, B, K, d, gs):
    """The int8 gather (#7) bit for bit against its own arithmetic
    (``ref.gather_sq_dists_int8_exact``) with 16-, 8-, 4-byte and byte
    chunks (aligned and unaligned code rows, groups that are and are not
    multiples of 4 or of a pass), and the fused gather bounds (#7', both
    entries, the pair list reading the kernel's d̂ through them) against
    the torch composition over its d̂; NO_NODE +inf in every output."""
    rng = _rng("g7", B, K, d, gs)
    st = build_store(torch.from_numpy(
        rng.normal(size=(80, d)).astype(np.float32)).to(dev), group_size=gs)
    qx, _, qe = quantize_queries(torch.from_numpy(
        rng.normal(size=(B, d)).astype(np.float32)).to(dev), st)
    idx = torch.from_numpy(rng.integers(-1, 80, (B, K)).astype(np.int32)
                           ).to(dev)
    valid = idx >= 0
    qi, yi = _pair_list(idx)
    kw = dict(group_size=gs)
    for codes in (st.q, _unaligned(st.q)):
        got = ops.gather_sq_dists_int8(codes, qx, idx, st.scales, **kw)
        assert torch.equal(got, ref.gather_sq_dists_int8_exact(
            codes, qx, idx, st.scales, **kw))
        assert bool(torch.isinf(got[~valid]).all())
        wlb, wub = ref.gather_bounds(
            got, qe[:, None] + st.err[idx.clamp_min(0).long()])
        n0 = ops.launch_counts()
        lb, ub = ops.gather_bounds_int8(codes, qx, idx, st.scales,
                                        err=st.err, qerr=qe, **kw)
        plb, pub = ops.gather_bounds_int8_pairs(codes, qx, qi, yi,
                                                st.scales, err=st.err,
                                                qerr=qe, **kw)
        n1 = ops.launch_counts()
        for k in ("gather_bounds_int8", "gather_bounds_int8_pairs"):
            assert n1[k] == n0[k] + 1, k
        assert torch.equal(lb, wlb) and torch.equal(ub, wub)
        assert torch.equal(plb, lb.reshape(-1))
        assert torch.equal(pub, ub.reshape(-1))


def test_int8_tiers_gather_bounds_and_refine_on_the_card(dev):
    """``Int8Tier``/``PdxTier`` ``gather_bounds`` and ``pair_refine`` on
    the card go through the fused kernel and equal, bit for bit, the
    composition the tiers ran before (the int8 gather's d̂, the slack,
    ``quant_lower_bound``/``quant_upper_bound``), query rows read in place
    for the pair list; out-of-range ids and query rows give +inf."""
    from repro_torch.quant.cascade import PdxTier
    from repro_torch.quant.pdx import build_pdx, pdx_queries
    rng = _rng("tiers")
    v = torch.from_numpy(rng.normal(size=(300, 128)).astype(np.float32)
                         ).to(dev)
    x = torch.from_numpy(rng.normal(size=(16, 128)).astype(np.float32)
                         ).to(dev)
    cand = torch.from_numpy(rng.integers(-1, 300, (16, 40)).astype(np.int32)
                            ).to(dev)
    qi = torch.from_numpy(np.sort(rng.integers(0, 16, 500))).to(dev)
    yi = torch.from_numpy(rng.integers(0, 300, 500)).to(dev)
    st8 = build_store(v)
    stp = build_pdx(v)
    for tier, qc, gs in ((Int8Tier(st8), Int8Tier(st8).encode(x), 128),
                         (PdxTier(stp), pdx_queries(x, stp), stp.slab)):
        st = tier.store
        ops.reset_launch_counts()
        lb, ub, _ = tier.gather_bounds(qc, cand, impl=None)
        plb, pub = tier.pair_refine(qc, qi, yi)
        counts = ops.launch_counts()
        assert counts["gather_bounds_int8"] == 1
        assert counts["gather_bounds_int8_pairs"] == 1
        dhat = ops.gather_sq_dists_int8(st.q, qc.q, cand, st.scales,
                                        group_size=gs)
        slack = qc.err[:, None] + st.err[cand.clamp_min(0).long()]
        assert torch.equal(lb, ops.quant_lower_bound(dhat, slack))
        assert torch.equal(ub, ops.quant_upper_bound(dhat, slack))
        pd = ops.gather_sq_dists_int8(
            st.q, qc.q[qi], yi.to(torch.int32)[:, None].contiguous(),
            st.scales, group_size=gs)[:, 0]
        ps = qc.err[qi] + st.err[yi]
        assert torch.equal(plb, ops.quant_lower_bound(pd, ps))
        assert torch.equal(pub, ops.quant_upper_bound(pd, ps))
    bad = torch.tensor([0, 16, -1], dtype=torch.int32, device=dev)
    ids = torch.tensor([5, 5, 5], dtype=torch.int32, device=dev)
    qc = Int8Tier(st8).encode(x)
    for d8 in ops.gather_bounds_int8_pairs(st8.q, qc.q, bad, ids, st8.scales,
                                           err=st8.err, qerr=qc.err):
        assert bool(torch.isfinite(d8[0])) and bool(torch.isinf(d8[1:]).all())
    f = ops.gather_sq_dists_pairs(v, x, bad, ids)
    assert bool(torch.isfinite(f[0])) and bool(torch.isinf(f[1:]).all())


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
    assert counts["gather_bounds_int8"] > 0 and counts["gather_sq_dists"] > 0
    np.testing.assert_array_equal(pair_keys(got.pairs, 1500),
                                  pair_keys(want.pairs, 1500))
    for f in ("n_dist", "n_iters", "n_ood", "n_rerank"):
        assert getattr(got.stats, f) == getattr(want.stats, f), f


def test_sq8_build_and_nlj_on_the_card(dev):
    ds = make_dataset("manifold", n_data=3000, n_query=64, dim=24, seed=5)
    theta = float(thresholds(ds, 7)[2])
    ops.reset_launch_counts()
    bs = BuildStats()
    eng = JoinEngine(ds.Y, build_kw=dict(k=24, degree=12, quant="sq8",
                                         build_stats=bs),
                     default=JoinConfig(theta=theta, quant="sq8"),
                     device=dev)
    res = eng.join(ds.X)
    counts = ops.launch_counts()
    for k in ("pairwise_bounds_int8", "gather_bounds_int8",
              "topk_merge", "pairlist_sq_dists", "gather_sq_dists"):
        assert counts[k] > 0, k
    # every bound block of the build's kNN sweep is one #6' launch
    assert bs.knn_blocks == counts["pairwise_bounds_int8"]
    assert bs.knn_sweep_s > 0
    f32 = build_index(np.concatenate([ds.Y, ds.X]), k=24, degree=12,
                      n_data=3000, device=dev)
    assert torch.equal(eng.merged_index(ds.X).nbrs, f32.nbrs)
    truth = exact_join_pairs(ds.X, eng.Y, theta)
    found, t = pair_keys(res.pairs, 3000), pair_keys(truth, 3000)
    assert np.setdiff1d(found, t).size == 0                     # sound
    nlj = eng.join(ds.X, method="nlj")
    np.testing.assert_array_equal(pair_keys(nlj.pairs, 3000), t)


# -- the sketch (Hamming) and PDX kernels ---------------------------------------

def _words(rng, *shape) -> torch.Tensor:
    w = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32))


@pytest.mark.parametrize("B,N,W", [(1, 1, 1), (3, 5, 2), (65, 129, 4),
                                   (300, 1000, 4), (20, 70, 40), (0, 5, 4),
                                   (5, 0, 4)])
def test_hamming_pairwise_kernel_matches_plain(dev, B, N, W):
    rng = _rng("ham", B, N, W)
    cx, cy = _words(rng, B, W), _words(rng, N, W)
    n0 = ops.launch_counts()["pairwise_hamming"]
    got = ops.pairwise_hamming(cx.to(dev), cy.to(dev))
    torch.cuda.synchronize()
    assert ops.launch_counts()["pairwise_hamming"] == n0 + (B * N > 0)
    assert torch.equal(got.cpu(), ref.pairwise_hamming(cx, cy))


@pytest.mark.parametrize("B,K,W", [(1, 1, 1), (3, 5, 2), (33, 65, 4),
                                   (256, 128, 4), (7, 9, 3), (0, 4, 4),
                                   (3, 0, 4)])
def test_hamming_rowwise_and_gather_kernels_match_plain(dev, B, K, W):
    rng = _rng("hamg", B, K, W)
    codes, cx = _words(rng, 60, W), _words(rng, B, W)
    idx = rng.integers(0, 60, (B, K)).astype(np.int32)
    idx[rng.random((B, K)) < 0.5] = -1          # NO_NODE reads no row
    idx = torch.from_numpy(idx)
    cands = codes[idx.clamp_min(0).long()]
    assert torch.equal(ops.rowwise_hamming(cx.to(dev), cands.to(dev)).cpu(),
                       ref.rowwise_hamming(cx, cands))
    assert torch.equal(
        ops.gather_hamming(codes.to(dev), cx.to(dev), idx.to(dev)).cpu(),
        ref.gather_hamming(codes, cx, idx))


def _flip_bits(words: np.ndarray, m: int) -> np.ndarray:
    """A uint32 code row with its first ``m`` bits flipped."""
    out = words.copy()
    for i in range(m):
        out[i // 32] ^= np.uint32(1 << (i % 32))
    return out


def _sketch_case(dev, B, K, d, key, n=300):
    """A sketch store over ``n`` rows (iso = 0.75) and ``B`` encoded
    queries on ``dev``: store rows 0 … len(hs) − 1 lie exactly hs[k] bits
    from query 0 (0 and d among them), and (B, K) ids hold NO_NODE and ids
    past the table."""
    from repro_torch.quant.sketch import build_sketch, sketch_queries
    rng = _rng("sk", B, K, d, key)
    scale = rng.uniform(0.2, 3.0, d)
    st = build_sketch(torch.from_numpy(
        (rng.normal(size=(n, d)) * scale).astype(np.float32)))
    qc, qcum = sketch_queries(torch.from_numpy(
        (rng.normal(size=(B, d)) * scale).astype(np.float32)), st)
    hs = st.hs.numpy()
    codes = st.codes.numpy().view(np.uint32).copy()
    idx = rng.integers(0, n + 10, (B, K)).astype(np.int32)
    idx[rng.random((B, K)) < 0.4] = -1
    if B:
        for r, m in enumerate(hs):
            codes[r] = _flip_bits(qc[0].numpy().view(np.uint32), int(m))
        k = min(K, len(hs))
        idx[0, :k] = np.arange(k)
    st = dataclasses.replace(st, codes=torch.from_numpy(codes.view(np.int32)),
                             iso=torch.tensor(0.75))
    return (_store_to(st, dev), qc.to(dev), qcum.to(dev),
            torch.from_numpy(idx).to(dev))


@pytest.mark.parametrize("B,K,d", [(1, 1, 40), (1, 20, 128), (7, 40, 150),
                                   (33, 300, 40), (256, 128, 128),
                                   (0, 4, 128), (3, 0, 128)])
def test_gather_sketch_bounds_kernel_is_the_composition(dev, B, K, d):
    """#9′ bit for bit ``ref.gather_sketch_bounds`` run on the card (the
    Hamming gather, ``sketch_lower_bound_gather`` and the estimate; with
    the plain Hamming counts and with #9's, the composition it replaced),
    lb and est, from aligned and unaligned code bases; within rounding of the
    same composition on the CPU; one launch a call."""
    st, qc, qcum, idx = _sketch_case(dev, B, K, d, "k")
    tabs = (qcum, st.cum, st.hs, st.iso)
    n0 = ops.launch_counts()["gather_sketch_bounds"]
    lb, est = ops.gather_sketch_bounds(st.codes, qc, idx, *tabs, dim=d)
    torch.cuda.synchronize()
    assert ops.launch_counts()["gather_sketch_bounds"] == n0 + (B * K > 0)
    assert lb.shape == est.shape == (B, K)
    assert lb.dtype == est.dtype == torch.float32
    for hamming in (ref.gather_hamming, ops.gather_hamming):
        wlb, west = ref.gather_sketch_bounds(st.codes, qc, idx, *tabs, dim=d,
                                             hamming=hamming)
        assert torch.equal(lb, wlb) and torch.equal(est, west)
    if B * K:
        ulb, uest = ops.gather_sketch_bounds(_unaligned(st.codes),
                                             _unaligned(qc), idx, *tabs,
                                             dim=d)
        assert torch.equal(ulb, lb) and torch.equal(uest, est)
    clb, cest = ref.gather_sketch_bounds(
        st.codes.cpu(), qc.cpu(), idx.cpu(), *(t.cpu() for t in tabs), dim=d)
    ok = ((idx >= 0) & (idx < st.n_vectors)).cpu()
    assert torch.equal(torch.isfinite(lb).cpu(), ok)
    assert torch.equal(torch.isfinite(est).cpu(), ok)
    energy = (qcum[:, -1:] + st.cum[idx.clamp(0, st.n_vectors - 1).long(),
                                    -1]).cpu()
    for got, want in ((lb, clb), (est, cest)):
        assert bool(((got.cpu() - want).abs()[ok] <= 1e-6 * energy[ok]).all())


def test_fused_wrappers_reject_what_the_kernels_do_not_take(dev):
    """#9′ and #11′ refuse a wrong dtype, device or shape."""
    st, qc, qcum, idx = _sketch_case(dev, 4, 8, 64, "rej")
    tabs = (qcum, st.cum, st.hs, st.iso)
    with pytest.raises(TypeError):
        ops.gather_sketch_bounds(st.codes, qc, idx.long(), *tabs, dim=64)
    with pytest.raises(ValueError, match="on cpu"):
        ops.gather_sketch_bounds(st.codes, qc, idx, qcum.cpu(), st.cum,
                                 st.hs, st.iso, dim=64)
    with pytest.raises(ValueError, match="shapes differ"):
        ops.gather_sketch_bounds(st.codes, qc, idx, qcum[:, 1:].contiguous(),
                                 st.cum, st.hs, st.iso, dim=64)
    pst, pqc = _pdx(dev, 50, 4, 64, "rej")
    ids = torch.zeros((4, 16), dtype=torch.int32, device=dev)
    mask = torch.ones((4, 16), dtype=torch.bool, device=dev)
    head = (pst.vp, pst.ftail, pst.ftail[:, 0].contiguous(), pqc.vp,
            pqc.ftail, pqc.ftail[:, 0].contiguous())
    kw = dict(dim=64, early_exit=True)
    with pytest.raises(TypeError):
        ops.pdx_compact_gather_sq_dists(*head, ids.long(), mask, 8, 1.0, **kw)
    with pytest.raises(TypeError):
        ops.pdx_compact_gather_sq_dists(*head, ids, mask.int(), 8, 1.0, **kw)
    with pytest.raises(ValueError, match="on cpu"):
        ops.pdx_compact_gather_sq_dists(*head, ids, mask.cpu(), 8, 1.0, **kw)
    with pytest.raises(ValueError, match="shapes differ"):
        ops.pdx_compact_gather_sq_dists(*head, ids, mask[:, 1:].contiguous(),
                                        8, 1.0, **kw)
    with pytest.raises(ValueError, match="contiguous rows"):
        ops.pdx_compact_gather_sq_dists(*head, ids, mask.t().contiguous().t(),
                                        8, 1.0, **kw)


def _pdx(dev, n, b, d, key):
    from repro_torch.quant.pdx import build_pdx, pdx_queries
    rng = _rng("pdx", n, b, d, key)
    scale = rng.uniform(0.2, 3.0, d)
    st = build_pdx(torch.from_numpy(
        (rng.normal(size=(n, d)) * scale).astype(np.float32)).to(dev))
    qc = pdx_queries(torch.from_numpy(
        (rng.normal(size=(b, d)) * scale).astype(np.float32)).to(dev), st)
    return st, qc


@pytest.mark.parametrize("B,N,d", [(1, 1, 8), (5, 9, 64), (129, 257, 128),
                                   (200, 1000, 150), (0, 5, 64),
                                   (5, 0, 64)])
def test_pdx_pairwise_kernel_matches_plain(dev, B, N, d):
    st, qc = _pdx(dev, max(N, 1), B, d, "pw")
    st = dataclasses.replace(st, **{f: getattr(st, f)[:N] for f in (
        "vp", "ftail", "q", "qslab", "qtail", "norms", "err")})
    for frac in (0.45, 1.2):
        med = float(torch.cdist(qc.vp[:32], st.vp[:512]).pow(2).median()) \
            if B * N else 1.0
        theta = (frac * med) ** 0.5
        args = (qc.q, st.q, st.scales, qc.qslab, st.qslab, qc.qtail,
                st.qtail, qc.norms, st.norms, qc.err, st.err, theta)
        kw = dict(slab=st.slab, dim=st.dim)
        off, n_off = ops.pairwise_sq_dists_pdx(*args, early_exit=False, **kw)
        on, n_on = ops.pairwise_sq_dists_pdx(*args, early_exit=True, **kw)
        cargs = tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                      for a in args)
        want, _ = ref.pairwise_sq_dists_pdx(*cargs, early_exit=False, **kw)
        _, wn = ref.pairwise_sq_dists_pdx(*cargs, early_exit=True, **kw)
        energy = (qc.norms[:, None] + st.norms[None, :]).cpu()
        assert off.shape == (B, N)
        assert bool(((off.cpu() - want).abs()
                     <= 1e-6 * want.abs() + 1e-6 * energy).all())
        assert torch.equal(n_on.cpu(), wn)
        surv = n_on == st.n_slabs
        assert torch.equal(on[surv], off[surv])          # bit-identical
        assert bool(torch.isinf(on[~surv]).all())
        assert bool((n_off == st.n_slabs).all())


# (B, N, d, slab): the existing shapes, slabs that are not a multiple of 32,
# B and N off the 128 x 64 tile, and a depth whose query tile streams
# through the ring (d = 2048 does not fit in shared memory with its tables)
PDX_EXACT = [(1, 1, 8, 64), (5, 9, 64, 64), (129, 257, 128, 64),
             (200, 1000, 150, 64), (0, 5, 64, 64), (5, 0, 64, 64),
             (130, 300, 100, 48), (67, 129, 120, 20), (3, 65, 40, 8),
             (257, 511, 128, 64), (40, 90, 2048, 64)]


@pytest.mark.parametrize("B,N,d,slab", PDX_EXACT)
@pytest.mark.parametrize("theta", ["retire-some", "retire-all",
                                   "retire-none"])
def test_pdx_pairwise_and_bounds_kernels_are_exact(dev, B, N, d, slab, theta):
    """#10 bit for bit its plain version run on the card (d̂ with early exit
    off, slab counts with it on), survivors bit-identical on and off; #10′
    (lb, ub, nscan) bit for bit ``ref.int8_bounds`` over #10's d̂ and
    #10's counts, and ``ref.pairwise_bounds_pdx``; also from unaligned
    code bases."""
    from repro_torch.quant.pdx import build_pdx, pdx_queries
    rng = _rng("pdx-exact", B, N, d, slab)
    scale = rng.uniform(0.2, 3.0, d)
    st = build_pdx(torch.from_numpy((rng.normal(size=(max(N, 1), d)) * scale)
                                    .astype(np.float32)).to(dev), slab=slab)
    st = dataclasses.replace(st, **{f: getattr(st, f)[:N] for f in (
        "vp", "ftail", "q", "qslab", "qtail", "norms", "err")})
    qc = pdx_queries(torch.from_numpy((rng.normal(size=(B, d)) * scale)
                                      .astype(np.float32)).to(dev), st)
    med = float(torch.cdist(qc.vp[:32], st.vp[:512]).pow(2).median()) \
        if B * N else 1.0
    th = {"retire-some": (0.45 * med) ** 0.5, "retire-all": 1e-3,
          "retire-none": 1e6}[theta]
    tabs = (qc.qslab, st.qslab, qc.qtail, st.qtail, qc.norms, st.norms,
            qc.err, st.err, th)
    kw = dict(slab=st.slab, dim=st.dim)
    bnd = (qc.norms, st.norms, qc.err, st.err, MATMUL_GUARD)
    S = st.n_slabs
    for qx, qy in ((qc.q, st.q), (_unaligned(qc.q), _unaligned(st.q))):
        args = (qx, qy, st.scales) + tabs
        off, n_off = ops.pairwise_sq_dists_pdx(*args, early_exit=False, **kw)
        on, n_on = ops.pairwise_sq_dists_pdx(*args, early_exit=True, **kw)
        want, _ = ref.pairwise_sq_dists_pdx(*args, early_exit=False, **kw)
        _, wn = ref.pairwise_sq_dists_pdx(*args, early_exit=True, **kw)
        assert off.shape == on.shape == (B, N)
        assert torch.equal(off, want) and torch.equal(n_on, wn)
        assert bool((n_off == S).all())
        surv = n_on == S
        assert torch.equal(on[surv], off[surv])
        assert bool(torch.isinf(on[~surv]).all())
        if theta == "retire-none":
            assert bool(surv.all())
        for ee, d_k, n_k in ((False, off, n_off), (True, on, n_on)):
            lb, ub, nb = ops.pairwise_bounds_pdx(*args, early_exit=ee, **kw)
            wlb, wub = ref.int8_bounds(d_k, *bnd)
            assert torch.equal(lb, wlb) and torch.equal(ub, wub)
            assert torch.equal(nb, n_k)
            plb, pub, pn = ref.pairwise_bounds_pdx(*args, early_exit=ee,
                                                   **kw)
            assert torch.equal(lb, plb) and torch.equal(ub, pub)
            assert torch.equal(nb, pn)


def test_pdx_tier_sweeps_through_the_bounds_kernel(dev):
    """``PdxTier.pairwise_bounds_ee`` on the card launches #10′ (not #10)
    and is bit for bit its plain version run on the card; against the
    tier on the CPU over the same store and queries, slab counts equal and
    bounds within 1e-6 relative (the CPU's and the card's torch ops may
    round the plain version's f32 steps apart)."""
    from repro_torch.quant.cascade import PdxTier
    from repro_torch.quant.pdx import build_pdx
    rng = _rng("pdx-tier")
    y = torch.from_numpy(rng.normal(size=(700, 96)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(70, 96)).astype(np.float32))
    cpu = PdxTier(build_pdx(y))
    card = PdxTier(_store_to(cpu.store, dev))
    theta = float(torch.cdist(x, y).median()) * 0.8
    qc = cpu.encode(x)
    qd, st = _store_to(qc, dev), card.store
    for ee in (False, True):
        ops.reset_launch_counts()
        got = card.pairwise_bounds_ee(qd, theta=theta, early_exit=ee,
                                      impl=None)
        counts = ops.launch_counts()
        assert counts["pairwise_bounds_pdx"] == 1
        assert counts["pairwise_sq_dists_pdx"] == 0
        plain = ref.pairwise_bounds_pdx(
            qd.q, st.q, st.scales, qd.qslab, st.qslab, qd.qtail, st.qtail,
            qd.norms, st.norms, qd.err, st.err, theta, slab=st.slab,
            dim=st.dim, early_exit=ee)
        for g, w in zip(got, plain):
            assert torch.equal(g, w)
        lb, ub, nscan = cpu.pairwise_bounds_ee(qc, theta=theta,
                                               early_exit=ee, impl=None)
        assert torch.equal(got[2].cpu(), nscan)
        for g, w in ((got[0], lb), (got[1], ub)):
            g = g.cpu()
            assert torch.equal(g.isinf(), w.isinf())
            fin = w.isfinite()
            assert bool(((g[fin] - w[fin]).abs() <= 1e-6 * w[fin]).all())


@pytest.mark.parametrize("B,K,d", [(1, 1, 8), (3, 5, 64), (33, 65, 128),
                                   (256, 128, 128), (9, 20, 150), (0, 4, 64),
                                   (3, 0, 64)])
def test_pdx_gather_kernel_matches_plain(dev, B, K, d):
    st, qc = _pdx(dev, 60, B, d, "g")
    rng = _rng("pdxg", B, K, d)
    idx = rng.integers(0, 60, (B, K)).astype(np.int32)
    idx[rng.random((B, K)) < 0.5] = -1
    idx = torch.from_numpy(idx).to(dev)
    vn, xn = st.ftail[:, 0].contiguous(), qc.ftail[:, 0].contiguous()
    med = float(torch.cdist(qc.vp, st.vp).pow(2).median()) if B else 1.0
    for frac in (0.45, 1.2):
        th2 = float(np.float32(frac * med))
        args = (st.vp, st.ftail, vn, qc.vp, qc.ftail, xn, idx, th2)
        off, _ = ops.pdx_gather_sq_dists(*args, dim=d, early_exit=False)
        on, n_on = ops.pdx_gather_sq_dists(*args, dim=d, early_exit=True)
        want, _ = ref.pdx_gather_sq_dists(
            *(a.cpu() if isinstance(a, torch.Tensor) else a for a in args),
            dim=d, early_exit=False)
        _close_rows(off, want)
        surv = (idx >= 0) & (n_on == st.n_slabs)
        assert torch.equal(on[surv], off[surv])
        ret = (idx >= 0) & (n_on < st.n_slabs)
        assert bool((want.to(dev)[ret] >= th2).all())


# (B, C, cap, d, slab): the band re-rank's pool (C = 1024) at cap 128 and
# 1024; ragged pools; a band too wide for one round of the staged list;
# slabs whose chunks take a group of 16 lanes (64), 2 (8), a whole warp with
# two chunks a lane (200), and words (30, not a multiple of 4); from an
# unaligned base, slabs 64 and 12 take the word map (a group of 16)
COMPACT_SHAPES = [(256, 1024, 128, 128, 64), (256, 1024, 1024, 128, 64),
                  (37, 300, 17, 70, 30), (9, 700, 64, 40, 8),
                  (5, 2000, 1500, 300, 200), (3, 50, 50, 24, 12),
                  (1, 1, 1, 8, 8)]


@pytest.mark.parametrize("B,C,cap,d,slab", COMPACT_SHAPES)
def test_pdx_compact_gather_kernel_is_the_composition(dev, B, C, cap, d,
                                                      slab):
    """#11′ bit for bit the composition it replaced on the card
    (``band_compact`` → #11 → ``band_scatter`` and the scan counters):
    ``exact``, ``within``, ``n_masked``, ``n_scanned`` and ``n_total``,
    early exit on and off, at thresholds where lanes retire and survive,
    with empty band rows, NO_NODE and ids past the table inside the band,
    from aligned and unaligned row bases, and with the pool a view of a
    wider buffer; one launch a call."""
    from repro_torch.quant.pdx import build_pdx, pdx_queries
    n = 500
    rng = _rng("pdx-compact", B, C, cap, d, slab)
    scale = rng.uniform(0.2, 3.0, d)
    st = build_pdx(torch.from_numpy((rng.normal(size=(n, d)) * scale)
                                    .astype(np.float32)).to(dev), slab=slab)
    qc = pdx_queries(torch.from_numpy((rng.normal(size=(B, d)) * scale)
                                      .astype(np.float32)).to(dev), st)
    ids = rng.integers(-1, n + 5, (B, C)).astype(np.int32)
    mask = rng.random((B, C)) < rng.uniform(0.05, 0.95, (B, 1))
    mask[1::7] = False                                 # empty band rows
    ids, mask = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
    vn, xn = st.ftail[:, 0].contiguous(), qc.ftail[:, 0].contiguous()
    med = float(torch.cdist(qc.vp, st.vp).pow(2).median())
    for th2 in (float(np.float32(0.45 * med)), float(np.float32(1.2 * med))):
        for vp in (st.vp, _unaligned(st.vp)):
            for ee in (False, True):
                args = (vp, st.ftail, vn, qc.vp, qc.ftail, xn, ids, mask,
                        cap, th2)
                n0 = ops.launch_counts()["pdx_compact_gather"]
                got = ops.pdx_compact_gather_sq_dists(*args, dim=d,
                                                      early_exit=ee)
                torch.cuda.synchronize()
                assert ops.launch_counts()["pdx_compact_gather"] == n0 + 1
                want = ref.pdx_compact_gather_sq_dists(
                    *args, dim=d, early_exit=ee,
                    gather=ops.pdx_gather_sq_dists)
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype and torch.equal(g, w)
    # a pool that is a view of a wider buffer (the traversal's pool_idx)
    wide = torch.full((B, C + 3), -1, dtype=torch.int32, device=dev)
    wide[:, :C] = ids
    wmask = torch.zeros((B, C + 5), dtype=torch.bool, device=dev)
    wmask[:, :C] = mask
    args = (st.vp, st.ftail, vn, qc.vp, qc.ftail, xn)
    got = ops.pdx_compact_gather_sq_dists(*args, wide[:, :C], wmask[:, :C],
                                          cap, th2, dim=d, early_exit=True)
    want = ops.pdx_compact_gather_sq_dists(*args, ids, mask, cap, th2, dim=d,
                                           early_exit=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("quant", ["sketch8", "pdx8", "sketchpdx8"])
def test_sketch_and_pdx_joins_on_the_card_match_the_cpu(dev, quant):
    ds = make_dataset("manifold", n_data=1500, n_query=96, dim=150, seed=3)
    d2 = np.sort(((ds.X.astype(np.float64)[:, None]
                   - ds.Y.astype(np.float64)[None]) ** 2).sum(-1), axis=None)
    theta = float(thresholds(ds, 3)[1])
    i = np.searchsorted(d2, theta ** 2)
    theta = float(np.sqrt(0.5 * (d2[i - 1] + d2[i])))   # mid-gap: no ties
    cpu = torch.device("cpu")
    merged = build_index(np.concatenate([ds.Y, ds.X]), k=24, degree=12,
                         n_data=1500, device=cpu)
    cfg = JoinConfig(theta=theta, wave_size=32, quant=quant)
    want_eng = JoinEngine(ds.Y, default=cfg, device=cpu)
    want = want_eng.join(ds.X, index_merged=merged)
    # the card's engine joins over the CPU engine's stores, so both sides
    # bound the same codes
    from repro_torch.engine.engine import _fingerprint
    from repro_torch.quant.cascade import TIERS_BY_MODE
    key = ("merged", _fingerprint(ds.X))
    stores = {n: _store_to(want_eng.tier_store(key, n, merged.vecs), dev)
              for n in TIERS_BY_MODE[quant]}
    ops.reset_launch_counts()
    eng = JoinEngine(ds.Y, default=cfg, device=dev)
    eng.adopt(X=ds.X, index_merged=_to(merged, dev), tier_stores=stores)
    got = eng.join(ds.X)
    counts = ops.launch_counts()
    if "sketch" in quant:          # the fused entries, never the bare ones
        assert counts["gather_sketch_bounds"] > 0
        assert counts["rowwise_hamming"] == 0
    if "pdx" in quant:
        assert counts["pdx_compact_gather"] > 0
        assert counts["pdx_gather_sq_dists"] == 0
    np.testing.assert_array_equal(pair_keys(got.pairs, 1500),
                                  pair_keys(want.pairs, 1500))
    for f in ("n_dist", "n_iters", "n_ood", "n_rerank", "n_esc8",
              "n_dims_scanned"):
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    truth = pair_keys(exact_join_pairs(ds.X, eng.Y, theta), 1500)
    ops.reset_launch_counts()
    nlj = eng.join(ds.X, method="nlj")
    np.testing.assert_array_equal(pair_keys(nlj.pairs, 1500), truth)
    assert ops.launch_counts()["pairwise_hamming" if "sketch" in quant
                               else "pairwise_bounds_pdx"] > 0


def _store_to(store, dev):
    return dataclasses.replace(store, **{
        f.name: getattr(store, f.name).to(dev)
        for f in dataclasses.fields(store)
        if isinstance(getattr(store, f.name), torch.Tensor)})


def _mid_gap_theta(x: np.ndarray, y: np.ndarray, q: float = 0.3) -> float:
    """θ near the q-quantile of the distances, at the middle of the widest
    float64 gap nearby: no pair within rounding of θ²."""
    d2 = np.sort(((x.astype(np.float64)[:, None] - y.astype(np.float64)[None])
                  ** 2).sum(-1), axis=None)
    if d2.size < 2:
        return 1.0
    i = min(max(int(q * d2.size), 1), d2.size - 1)
    lo, hi = max(i - 8, 1), min(i + 8, d2.size - 1)
    j = lo + int(np.argmax(d2[lo:hi + 1] - d2[lo - 1:hi]))
    return float(np.sqrt(0.5 * (d2[j - 1] + d2[j])))


@pytest.mark.parametrize("B,N,d", PAIRWISE_SHAPES + [(129, 257, 3),
                                                     (200, 1000, 130)])
def test_nlj_count_kernel_matches_plain(dev, B, N, d):
    """Counts exact against the plain version (θ mid-gap) and against the
    pairwise kernel's own distances compared with θ² (any θ: the two
    kernels share the tile and the epilogue)."""
    rng = _rng("nlj", B, N, d)
    x = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(N, d)).astype(np.float32))
    theta = _mid_gap_theta(x.numpy(), y.numpy())
    xd, yd = x.to(dev), y.to(dev)
    for th in (theta, 0.0):
        n0 = ops.launch_counts()["nlj_count"]
        got = ops.nlj_count(xd, yd, theta=th)
        torch.cuda.synchronize()
        assert ops.launch_counts()["nlj_count"] == n0 + (B * N * d > 0)
        assert got.dtype == torch.int32 and got.shape == (B,)
        assert torch.equal(got.cpu(), ref.nlj_count(x, y, th) if d else
                           ops.nlj_count(x, y, theta=th))
    th2 = float(np.float32(1.1 * theta) ** 2)
    via_pairwise = (ops.pairwise_sq_dists(xd, yd) < th2).sum(
        1, dtype=torch.int32)
    assert torch.equal(ops.nlj_count(xd, yd, theta=1.1 * theta),
                       via_pairwise)
    assert torch.equal(ops.nlj_mask(xd, yd, theta=theta).cpu(),
                       ref.nlj_mask(x, y, theta))


@pytest.mark.parametrize("method", ["es_sws", "es_hws"])
def test_search_join_on_the_card_matches_the_cpu(dev, method):
    """The search path on the card over the CPU engine's G_Y and G_X: the
    same pairs and counters, through the greedy search's kernels."""
    ds = make_dataset("manifold", n_data=1500, n_query=96, dim=32, seed=3)
    d2 = np.sort(((ds.X.astype(np.float64)[:, None]
                   - ds.Y.astype(np.float64)[None]) ** 2).sum(-1), axis=None)
    theta = float(thresholds(ds, 3)[1])
    i = np.searchsorted(d2, theta ** 2)
    theta = float(np.sqrt(0.5 * (d2[i - 1] + d2[i])))   # mid-gap: no ties
    cpu = torch.device("cpu")
    iy = build_index(ds.Y, k=24, degree=12, device=cpu)
    ix = build_index(ds.X, k=24, degree=12, device=cpu)
    cfg = JoinConfig(method=method, theta=theta, wave_size=32)
    want = JoinEngine(ds.Y, default=cfg, device=cpu).join(
        ds.X, index_y=iy, index_x=ix)
    ops.reset_launch_counts()
    got = JoinEngine(ds.Y, default=cfg, device=dev).join(
        ds.X, index_y=_to(iy, dev), index_x=_to(ix, dev))
    counts = ops.launch_counts()
    assert counts["gather_sq_dists"] > 0 and counts["rowwise_sq_dists"] > 0
    np.testing.assert_array_equal(pair_keys(got.pairs, 1500),
                                  pair_keys(want.pairs, 1500))
    for f in ("n_dist", "n_iters", "cache_hits", "cache_misses",
              "peak_cache_entries"):
        assert getattr(got.stats, f) == getattr(want.stats, f), f


def _record_parents(eng) -> list:
    log = []
    choose = eng._assign_parents

    def recorded(*a, **kw):
        log.append(choose(*a, **kw))
        return log[-1]
    eng._assign_parents = recorded
    return log


def test_stream_parents_through_the_int8_kernel(dev):
    """Streaming under sq8 on the card over the CPU engine's G_Y and int8
    store: each wave's parents come from #6 (``pairwise_sq_dists_int8``)
    over the carry window padded to its full width, bit for bit its own
    arithmetic (``ref.pairwise_sq_dists_int8_exact``) on the same window,
    and equal the CPU engine's parents (its plain, dequantizing d̂) but
    for near-ties (d̂ in float64 within 1e-6, relative); with no near-tie
    the batches' pairs and counters equal the CPU run's."""
    ds = make_dataset("manifold", n_data=1500, n_query=96, dim=40, seed=3)
    theta = float(thresholds(ds, 3)[1])
    cpu = torch.device("cpu")
    iy = build_index(ds.Y, k=24, degree=12, device=cpu)
    cfg = JoinConfig(method="es_sws", theta=theta, wave_size=32,
                     quant="sq8")
    key = ("int8", "index_y")
    runs = {}
    for d in (cpu, dev):
        eng = JoinEngine(ds.Y, default=cfg, carry_window=64, device=d)
        if d == cpu:
            eng.adopt(index_y=iy)
        else:
            eng.adopt(index_y=_to(iy, dev))
            eng._tier_stores.put(key, _store_to(
                runs[cpu][0]._tier_stores[key], dev))
        log = _record_parents(eng)
        ops.reset_launch_counts()
        res = [eng.submit(ds.X[b:b + 32]) for b in range(0, 96, 32)]
        runs[d] = (eng, log, res, ops.launch_counts())
    eng, log, res, counts = runs[dev]
    # batches 2 and 3 pick parents (one wave each); one sticky estimate
    assert counts["pairwise_sq_dists_int8"] == 2
    assert counts["pairwise_hamming"] == 1
    # the card's parents against the CPU engine's, wave by wave
    st_cpu = runs[cpu][0]._tier_stores[key]
    x64 = dequantize(quantize_queries(torch.from_numpy(ds.X), st_cpu)[0],
                     st_cpu.scales, st_cpu.group_size).double().numpy()
    ties = 0
    for pg, pw in zip(log, runs[cpu][1], strict=True):
        assert pg.keys() == pw.keys()
        for q, p in pg.items():
            if p != pw[q]:
                a, b = (((x64[q] - x64[r]) ** 2).sum() for r in (p, pw[q]))
                assert abs(a - b) <= 1e-6 * max(a, b), (q, p, pw[q])
                ties += 1
    if ties == 0:
        for g, w in zip(res, runs[cpu][2]):
            np.testing.assert_array_equal(pair_keys(g.pairs, 1500),
                                          pair_keys(w.pairs, 1500))
            for f in ("n_dist", "n_iters", "cache_hits", "cache_evictions",
                      "n_rerank"):
                assert getattr(g.stats, f) == getattr(w.stats, f), f
    # one more wave against the window (the last 64 of the 96 queries)
    st = eng._tier_stores[key]
    xw = ds.X[:32]
    qc = Int8Tier(st).encode(torch.as_tensor(xw, device=dev))
    qids = np.arange(96, 128)
    got = eng._assign_parents(xw, qc, Int8Tier(st), qids, np.ones(32, bool),
                              True)
    n = len(eng._carry_qids)
    C = torch.zeros((eng.carry_window, 40), dtype=torch.int8, device=dev)
    Nn = torch.zeros(eng.carry_window, device=dev)
    C[:n] = torch.as_tensor(eng._carry_codes, device=dev)
    Nn[:n] = torch.as_tensor(eng._carry_norms, device=dev)
    d2 = ref.pairwise_sq_dists_int8_exact(qc.q, C, st.scales, qc.norms, Nn,
                                          group_size=st.group_size)[:, :n]
    want = eng._carry_qids[d2.argmin(dim=1).cpu().numpy()]
    assert got == {int(q): int(p) for q, p in zip(qids, want)}


@pytest.mark.parametrize("d", [40, 128])
def test_sketch_survivors_through_the_hamming_kernel(dev, d):
    """``sketch_survivors`` on the card (#8 ``pairwise_hamming``, then the
    certified bounds) equals the same bounds over the plain Hamming
    counts on the same card, at a θ that keeps part of the sample."""
    from repro_torch.quant.sketch import (build_sketch,
                                          sketch_lower_bound_pairwise,
                                          sketch_queries, sketch_survivors)
    g = _rng("survivors", d)
    y = g.normal(size=(2048, d)).astype(np.float32)
    x = g.normal(size=(64, d)).astype(np.float32)
    st = build_sketch(y, device=dev)
    qc, qcum = sketch_queries(torch.as_tensor(x, device=dev), st)
    lb = sketch_lower_bound_pairwise(ref.pairwise_hamming(qc, st.codes),
                                     qcum, st.cum, st.hs, st.iso, dim=d)
    theta = float(lb.flatten().kthvalue(lb.numel() // 20).values.sqrt())
    ops.reset_launch_counts()
    got = sketch_survivors(x, st, theta)
    assert ops.launch_counts()["pairwise_hamming"] == 1
    want = (lb <= float(np.float32(theta) ** 2)).cpu().numpy()
    assert got.dtype == bool and got.shape == (64, 2048)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


def test_service_on_the_card_equals_its_direct_replay(dev):
    """``JoinService`` with two tenants on the card (f32 and sq8 requests,
    pinned, planner-routed and at a reduced recall budget, served through
    ``submit_many``): each tenant's ``reset_stream`` and a direct
    ``submit(X, svc.plan(req))`` per request in dispatch order give the
    served pairs and counters; the kernel-build count stays flat after
    warmup; warmup and serving launched #3, and under sq8 #6, #7′ and #8
    (the LSH cap estimate, made once in warmup)."""
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs.metrics import Metrics
    from repro_torch.serve import JoinRequest, JoinService, ServiceConfig

    data = {"a": make_dataset("manifold", n_data=1500, n_query=96, dim=40,
                              seed=3),
            "b": make_dataset("clustered", n_data=1200, n_query=96, dim=40,
                              seed=4)}
    svc = JoinService(ServiceConfig(buckets=(16, 32)), metrics=Metrics())
    thetas = {}
    ops.reset_launch_counts()
    for name, ds in data.items():
        thetas[name] = float(thresholds(ds, 3)[1])
        svc.load(name, torch.as_tensor(ds.Y, device=dev),
                 build_kw=dict(k=24, degree=12),
                 default=JoinConfig(method="es_sws"),
                 engine_kw=dict(carry_window=64, device=dev))
        svc.warmup(name, thetas=[thetas[name]], quants=("off", "sq8"))
    c0 = obs_metrics.compile_count()
    g = _rng("service")
    reqs = []
    for uid in range(16):
        name = "ab"[uid % 2]
        n = int(g.integers(1, 48))
        lo = int(g.integers(0, 96 - n))
        r = JoinRequest(uid=uid, tenant=name, X=data[name].X[lo:lo + n],
                        theta=thetas[name], method="es_sws",
                        quant=("off", "sq8")[(uid // 2) % 2])
        if uid % 5 == 4:
            r.method = r.quant = None
        if uid % 4 == 3:
            r.recall_budget = 0.5
        reqs.append(r)
        assert svc.submit(r)
    done = svc.run()
    counts = ops.launch_counts()
    assert obs_metrics.compile_count() == c0
    assert all(sj.ok for sj in done.values()) and len(done) == 16
    for k in ("gather_sq_dists", "gather_bounds_int8",
              "pairwise_sq_dists_int8", "pairwise_hamming"):
        assert counts[k] > 0, k
    for name in data:
        eng = svc.engine(name)
        eng.reset_stream()
        for r in (r for r in reqs if r.tenant == name):
            direct = eng.submit(r.X, svc.plan(r))
            sj = done[r.uid]
            np.testing.assert_array_equal(pair_keys(direct.pairs, 1500),
                                          pair_keys(sj.pairs, 1500))
            for f in ("n_dist", "n_iters", "n_rerank", "cache_hits",
                      "cache_evictions", "cache_tombstones"):
                assert getattr(direct.stats, f) == getattr(sj.stats, f), f


def test_sharded_joins_on_the_card_match_the_cpu(dev):
    """Two shards on ``cuda:0`` (a ``DeviceMesh`` of one card twice): the
    mesh MI join in f32 and under sq8, on the CPU mesh's per-shard indexes
    copied to the card, and the mesh NLJ give the CPU mesh's pairs and
    counters; the NLJ also the card's single-device exact NLJ exactly (both
    run #1). The MI join launched #3 (f32) and #7′ (sq8), the NLJ #1."""
    from repro_torch.core import distributed as D
    from repro_torch.obs.metrics import Metrics

    ds = make_dataset("manifold", n_data=1501, n_query=96, dim=32, seed=3)
    d2 = np.sort(((ds.X.astype(np.float64)[:, None]
                   - ds.Y.astype(np.float64)[None]) ** 2).sum(-1), axis=None)
    theta = float(thresholds(ds, 3)[1])
    i = np.searchsorted(d2, theta ** 2)
    theta = float(np.sqrt(0.5 * (d2[i - 1] + d2[i])))   # mid-gap: no ties
    cpu = torch.device("cpu")
    smi = D.build_sharded_merged_index(ds.Y, ds.X, 2, devices=(cpu, cpu),
                                       k=24, degree=12)
    card = D.ShardedMergedIndex(
        shards=tuple(_to(g, dev) for g in smi.shards),
        shard_size=smi.shard_size, n_query=smi.n_query)
    engines = {}
    for name, mesh, index in (("cpu", D.DeviceMesh.on_device(cpu, 2), smi),
                              ("card", D.DeviceMesh.on_device(dev, 2),
                               card)):
        eng = JoinEngine(ds.Y, n_shards=2, mesh=mesh, metrics=Metrics())
        eng.adopt(X=ds.X, index_sharded=index)
        engines[name] = eng
    for quant, kernel in (("off", "gather_sq_dists"),
                          ("sq8", "gather_bounds_int8")):
        cfg = JoinConfig(theta=theta, wave_size=32, quant=quant)
        want = engines["cpu"].join(ds.X, cfg)
        ops.reset_launch_counts()
        got = engines["card"].join(ds.X, cfg)
        assert ops.launch_counts()[kernel] > 0, kernel
        np.testing.assert_array_equal(pair_keys(got.pairs, 1501),
                                      pair_keys(want.pairs, 1501))
        for f in ("n_dist", "n_rerank", "overflow_retries", "n_iters",
                  "band_occ_per_shard", "bytes_allgather"):
            assert getattr(got.stats, f) == getattr(want.stats, f), f
        assert len(got.pairs) > 100
    cfg = JoinConfig(method="nlj", theta=theta, wave_size=32)
    want = engines["cpu"].join(ds.X, cfg)
    ops.reset_launch_counts()
    got = engines["card"].join(ds.X, cfg)
    assert ops.launch_counts()["pairwise_sq_dists"] > 0
    single = exact_join_pairs(ds.X, torch.as_tensor(ds.Y, device=dev), theta)
    for other in (want.pairs, single):
        np.testing.assert_array_equal(pair_keys(got.pairs, 1501),
                                      pair_keys(other, 1501))


def _lm_inputs(mc, rng, b: int, s: int, start=0):
    """Inputs (tokens or frames) and positions ((b, s), or three M-RoPE
    streams) of the LM tests."""
    x = (rng.normal(size=(b, s, mc.frontend_dim)).astype(np.float32)
         if mc.input_kind == "embeddings"
         else rng.integers(0, mc.vocab, (b, s)).astype(np.int32))
    t = np.arange(s, dtype=np.int32) + np.asarray(start, np.int32).reshape(
        -1, 1)
    t = np.broadcast_to(t, (b, s)).copy()
    p = np.stack([t, t // 2, t % 3], -1) if mc.pos_dims == 3 else t
    return torch.from_numpy(x), torch.from_numpy(p)


def _lm_pair(arch: str, dev):
    """An arch's smoke config in f32 and one set of random weights on the
    CPU and on the card."""
    mc = arch_spec(arch).smoke.with_overrides(dtype=torch.float32)
    cpu = LM.init_params(mc, device="cpu",
                         generator=torch.Generator().manual_seed(1))
    return mc, cpu, copy.deepcopy(cpu).to(dev)


def _lm_close(got, want):
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_on_the_card_matches_the_cpu(dev, arch):
    """Forward (and logits), then for decodable archs prefill of a 7- and a
    20-token prompt into two lanes (20 passes the smoke window of 16) and
    four decode steps at their ragged lengths: logits and every cache leaf
    on the card = the CPU's within 1e-4."""
    mc, cpu, card = _lm_pair(arch, dev)
    rng = np.random.default_rng(zlib.crc32(arch.encode()))
    x, p = _lm_inputs(mc, rng, 2, 12)
    h = LM.forward(card, x.to(dev), p.to(dev))
    h_cpu = LM.forward(cpu, x, p)
    _lm_close(h, h_cpu)
    _lm_close(LM.logits_fn(card, h), LM.logits_fn(cpu, h_cpu))
    if mc.encoder_only:
        return
    lens = np.array([7, 20], np.int32)
    caches = {d: LM.init_caches(mc, 2, 32, d) for d in ("cpu", dev)}
    models = {"cpu": cpu, dev: card}
    for lane, n in enumerate(lens):
        x, p = _lm_inputs(mc, rng, 1, int(n))
        out = {d: LM.prefill(m, x.to(d), p.to(d), 32)
               for d, m in models.items()}
        _lm_close(out[dev][0], out["cpu"][0])
        for d, (_, one) in out.items():
            for c, c1 in zip(caches[d], one):
                for k in c:
                    c[k][lane] = c1[k][0]
    for i in range(4):
        tok = torch.from_numpy(rng.integers(0, mc.vocab, (2, 1)).astype(
            np.int32))
        _, p = _lm_inputs(mc, rng, 2, 1, lens + i)
        ci = torch.from_numpy(lens + i)
        out = {d: LM.decode_step(m, tok.to(d), p.to(d), caches[d], ci.to(d))
               for d, m in models.items()}
        _lm_close(out[dev][0], out["cpu"][0])
    for a, b in zip(caches[dev], caches["cpu"]):
        for k in a:
            _lm_close(a[k], b[k])


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "gemma2_9b",
                                  "deepseek_v2_236b", "jamba_1_5_large_398b",
                                  "qwen2_vl_72b"])
def test_serve_engine_on_the_card_matches_the_cpu(dev, arch):
    """Two slots, seven requests (prompts of 3 to 24 tokens, 12 new each):
    the card's greedy tokens and stats = the CPU's."""
    from repro_torch.obs.metrics import Metrics
    from repro_torch.serve import Request, ServeEngine

    mc, cpu, card = _lm_pair(arch, dev)
    rng = np.random.default_rng(8)
    reqs = [Request(uid=i, prompt=_lm_inputs(mc, rng, 1, n)[0][0].numpy(),
                    max_new=12)
            for i, n in enumerate((3, 24, 9, 17, 5, 24, 11))]
    runs = {d: ServeEngine(mc, m, n_slots=2, s_max=40, metrics=Metrics(),
                           device=d) for d, m in (("cpu", cpu), (dev, card))}
    done = {d: eng.run(reqs) for d, eng in runs.items()}
    assert done[dev] == done["cpu"] and len(done["cpu"]) == len(reqs)
    assert dict(runs[dev].stats) == dict(runs["cpu"].stats)


def test_sampled_decoding_on_the_card_is_deterministic_and_lane_independent(
        dev):
    """Sampled decoding with the noise drawn on the card: a rerun gives the
    same tokens, and a request's tokens do not depend on the other lane."""
    from repro_torch.obs.metrics import Metrics
    from repro_torch.serve import Request, ServeEngine

    mc, _, card = _lm_pair("tinyllama_1_1b", dev)
    rng = np.random.default_rng(13)
    prompts = [_lm_inputs(mc, rng, 1, n)[0][0].numpy() for n in (5, 9, 14)]

    def run(prs, slots):
        eng = ServeEngine(mc, card, n_slots=slots, s_max=40, temperature=0.8,
                          seed=9, metrics=Metrics(), device=dev)
        return eng.run([Request(uid=i, prompt=p, max_new=12)
                        for i, p in enumerate(prs)])

    both = run(prompts, 2)
    assert both == run(prompts, 2)
    assert both[0] == run(prompts[:1], 1)[0]
    assert both[2] == run([np.zeros(0, np.int32)] * 2 + prompts[2:], 2)[2]
    greedy = ServeEngine(mc, card, n_slots=2, s_max=40, metrics=Metrics(),
                         device=dev).run([Request(uid=i, prompt=p, max_new=12)
                                          for i, p in enumerate(prompts)])
    assert greedy != both


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "gemma2_9b",
                                  "deepseek_v2_236b", "jamba_1_5_large_398b",
                                  "qwen2_vl_72b", "rwkv6_7b"])
def test_training_step_on_the_card_matches_the_cpu(dev, arch):
    """One AdamW step (f32 moments, 2 micro-batches) of the f32 smoke
    config from the same weights and batch: loss, aux, ntok and grad norm
    on the card = the CPU's within 1e-5 relative, and every parameter
    within 3e-5 (a first Adam step moves a parameter by about lr·sign(g),
    lr = 1e-5, so a grad near 0 may step the other way: 2·lr apart)."""
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step

    mc, cpu, card = _lm_pair(arch, dev)
    rng = np.random.default_rng(zlib.crc32(f"{arch}/train".encode()))
    x, p = _lm_inputs(mc, rng, 4, 16)
    tg = torch.from_numpy(rng.integers(0, mc.vocab, (4, 16)).astype(np.int32))
    tg[0, -3:] = -1
    before = [q.detach().clone() for q in cpu.parameters()]
    out = {}
    for d, model in (("cpu", cpu), (dev, card)):
        opt = adamw()
        state = opt.init(dict(model.named_parameters()))
        step = make_train_step(mc, opt, lambda s: 1e-5, microbatches=2)
        batch = dict(inputs=x.to(d), targets=tg.to(d), positions=p.to(d))
        _, _, m = step(model, state, batch, 0)
        out[d] = {k: float(m[k]) for k in ("loss", "aux", "ntok",
                                           "grad_norm")}
    for k, v in out["cpu"].items():
        assert abs(out[dev][k] - v) <= 1e-5 * max(abs(v), 1.0), (k, out)
    moved = 0.0
    for (n, a), b, b0 in zip(card.named_parameters(), cpu.parameters(),
                             before):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0,
                                   atol=3e-5, msg=n)
        moved = max(moved, float((b.detach() - b0).abs().max()))
    assert moved > 5e-6


def test_dot_f32_backward_on_the_card_matches_the_cpu_route(dev):
    """bf16 operands: the card's ``torch.mm(out_dtype=f32)`` under
    ``_MmF32`` and the CPU route's upcast product give the same f32
    output and, rounded to bf16, the same cotangents (within one bf16 ulp
    of the largest)."""
    from repro_torch.models.layers import dot_f32
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(3, 40, 96, generator=gen).bfloat16()
    w = (torch.randn(96, 300, generator=gen) / 10).bfloat16()
    r = torch.randn(3, 40, 300, generator=gen)
    res = {}
    for d in ("cpu", dev):
        xd = x.to(d, copy=True).requires_grad_(True)
        wd = w.to(d, copy=True).requires_grad_(True)
        out = dot_f32(xd, wd)
        (out * r.to(d)).sum().backward()
        res[d] = [out.detach().cpu(), xd.grad.float().cpu(),
                  wd.grad.float().cpu()]
    assert res[dev][0].dtype == torch.float32
    torch.testing.assert_close(res[dev][0], res["cpu"][0], rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(res[dev][1:], res["cpu"][1:]):
        assert float((a - b).abs().max()) <= 2.0**-8 * float(b.abs().max())


def test_bf16_checkpoint_round_trip_from_the_card(dev, tmp_path):
    """Card tensors (bf16 weights, f32 and int32 state) saved and restored
    bit for bit, onto the card; a save holds the values it was given, not
    an in-place update made after it returned."""
    from repro_torch.checkpoint import CheckpointManager
    gen = torch.Generator(device=dev).manual_seed(2)
    tree = dict(params={"w": torch.randn(64, 33, generator=gen,
                                         device=dev).bfloat16()},
                opt_state=dict(mu={"w": torch.randn(64, 33, generator=gen,
                                                    device=dev)},
                               step=torch.tensor(3, dtype=torch.int32,
                                                 device=dev)))
    want = {"w": tree["params"]["w"].clone(),
            "mu": tree["opt_state"]["mu"]["w"].clone()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, tree)
    tree["params"]["w"].mul_(2)
    step, back = mgr.restore(tree, device=dev)
    assert step == 3 and back["params"]["w"].device.type == "cuda"
    assert back["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(back["params"]["w"], want["w"])
    assert torch.equal(back["opt_state"]["mu"]["w"], want["mu"])
    assert int(back["opt_state"]["step"]) == 3
