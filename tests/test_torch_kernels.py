"""Distance kernels of the PyTorch port against the JAX package.

The port's plain versions (``repro_torch.kernels.ref``, what its
dispatcher runs for CPU tensors) are held against ``repro.kernels.ops`` at
``impl="ref"`` and ``impl="pallas_interpret"`` (the Pallas kernel bodies
run in interpret mode), on the same numpy inputs, over sub-block, ragged
and empty shapes and NO_NODE ids. The CUDA kernels themselves run only on
the card: ``tests/test_torch_cuda.py`` holds them against these plain
versions there.

Tolerances: pairwise ``atol = 1e-5·(‖x‖²+‖y‖²)``, ``rtol = 1e-5`` (the
matmul form cancels and the summation order differs); rowwise and gather
``rtol = 1e-6``, ``atol = 1e-6·max d`` (sums of squares in another order).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

JAX_IMPLS = ("ref", "pallas_interpret")
PAIRWISE_SHAPES = [(1, 1, 1), (3, 5, 7), (9, 130, 33), (16, 200, 128),
                   (0, 4, 8), (4, 0, 8), (5, 7, 0)]
ROW_SHAPES = [(1, 1, 1), (3, 5, 7), (9, 33, 130), (8, 128, 64),
              (0, 4, 8), (3, 0, 8), (5, 3, 0)]


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


def _assert_pairwise(got, want, x, y):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    xn = (x.astype(np.float64) ** 2).sum(1)[:, None]
    yn = (y.astype(np.float64) ** 2).sum(1)[None, :]
    assert np.all(np.abs(got - want) <= 1e-5 * (xn + yn) + 1e-5 * np.abs(want))


def _assert_rows(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    if fin.any():
        g, w = got[fin], want[fin]
        assert np.all(np.abs(g - w) <= 1e-6 * np.abs(w) + 1e-6 * np.abs(w).max())


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("B,N,d", PAIRWISE_SHAPES)
def test_pairwise_matches_jax(B, N, d, impl):
    rng = _rng("pw", B, N, d)
    x = rng.normal(size=(B, d)).astype(np.float32)
    y = rng.normal(size=(N, d)).astype(np.float32)
    got = ops.pairwise_sq_dists(torch.from_numpy(x), torch.from_numpy(y))
    want = jops.pairwise_sq_dists(jnp.asarray(x), jnp.asarray(y), impl=impl)
    assert got.dtype == torch.float32 and (got >= 0).all()
    _assert_pairwise(got.numpy(), want, x, y)


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("B,K,d", ROW_SHAPES)
def test_rowwise_matches_jax(B, K, d, impl):
    rng = _rng("rw", B, K, d)
    x = rng.normal(size=(B, d)).astype(np.float32)
    c = rng.normal(size=(B, K, d)).astype(np.float32)
    got = ops.rowwise_sq_dists(torch.from_numpy(x), torch.from_numpy(c))
    want = jops.rowwise_sq_dists(jnp.asarray(x), jnp.asarray(c), impl=impl)
    _assert_rows(got.numpy(), want)


# the reference's Pallas gather takes no d = 0 rows (its block would be
# empty); that shape is held against the reference's plain version only
GATHER_CASES = [(B, K, d, impl) for B, K, d in ROW_SHAPES for impl in JAX_IMPLS
                if d > 0 or impl == "ref"]


@pytest.mark.parametrize("frac_none", [0.0, 0.4, 1.0])
@pytest.mark.parametrize("B,K,d,impl", GATHER_CASES)
def test_gather_matches_jax(B, K, d, impl, frac_none):
    rng = _rng("g", B, K, d, frac_none)
    n = 40
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    x = rng.normal(size=(B, d)).astype(np.float32)
    idx = rng.integers(0, n, (B, K)).astype(np.int32)
    idx[rng.random((B, K)) < frac_none] = -1
    got = ops.gather_sq_dists(torch.from_numpy(vecs), torch.from_numpy(x),
                              torch.from_numpy(idx))
    want = jops.gather_sq_dists(jnp.asarray(vecs), jnp.asarray(x),
                                jnp.asarray(idx), impl=impl)
    _assert_rows(got.numpy(), want)
    # the traversal's use: gather == rowwise over the clamped rows, masked
    if B and K and d:
        rows = ref.rowwise_sq_dists(torch.from_numpy(x),
                                    torch.from_numpy(vecs[np.maximum(idx, 0)]))
        masked = torch.where(torch.from_numpy(idx) >= 0, rows, torch.inf)
        assert torch.equal(got, masked)


def test_topk_merge_is_stable_like_jax():
    rng = np.random.default_rng(0)
    # few distinct values: many ties between beam and candidates
    bd = np.sort(rng.integers(0, 4, (6, 8)).astype(np.float32), axis=1)
    bi = rng.integers(0, 100, (6, 8)).astype(np.int32)
    cd = rng.integers(0, 4, (6, 11)).astype(np.float32)
    ci = rng.integers(0, 100, (6, 11)).astype(np.int32)
    cd[0, 3] = np.inf
    gd, gi = ref.topk_merge(*map(torch.from_numpy, (bd, bi, cd, ci)))
    wd, wi = jref.topk_merge(*map(jnp.asarray, (bd, bi, cd, ci)))
    assert np.array_equal(gd.numpy(), np.asarray(wd))
    assert np.array_equal(gi.numpy(), np.asarray(wi))


def test_dispatch_never_falls_back():
    x = torch.zeros(2, 3)
    assert ops.default_impl(x) == "ref"
    with pytest.raises(ValueError, match="CUDA"):
        ops.pairwise_sq_dists(x, x, impl="cuda")
    assert ops.pairwise_sq_dists(x, x, impl="ref").shape == (2, 2)
    with pytest.raises(ValueError, match="impl"):
        ops.rowwise_sq_dists(x, x[:, None], impl="pallas")
    before = ops.launch_counts()
    ops.gather_sq_dists(x, x, torch.zeros(2, 1, dtype=torch.int32))
    assert ops.launch_counts() == before      # plain version: no launch


def _clear_nlj_theta(x, y, q: float = 0.3) -> float:
    """θ near the q-quantile of the pairs' distances, moved to the middle
    of the widest gap between neighbouring float64 squared distances
    nearby, so no pair lies within rounding of θ²."""
    d2 = np.sort(((x.astype(np.float64)[:, None] - y.astype(np.float64)[None])
                  ** 2).sum(-1), axis=None)
    if d2.size < 2:
        return 1.0
    i = min(max(int(q * d2.size), 1), d2.size - 1)
    lo, hi = max(i - 8, 1), min(i + 8, d2.size - 1)
    j = lo + int(np.argmax(d2[lo:hi + 1] - d2[lo - 1:hi]))
    return float(np.sqrt(0.5 * (d2[j - 1] + d2[j])))


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("B,N,d", PAIRWISE_SHAPES)
def test_nlj_count_and_mask_match_jax(B, N, d, impl):
    """Integer counts: exact, θ cleared of boundary pairs; θ = 0 counts
    nothing; the reference's empty-shape contract (d = 0: every distance
    is 0, so N pairs when θ > 0)."""
    rng = _rng("nlj", B, N, d)
    x = rng.normal(size=(B, d)).astype(np.float32)
    y = rng.normal(size=(N, d)).astype(np.float32)
    theta = _clear_nlj_theta(x, y)
    for th in (theta, 0.0):
        got = ops.nlj_count(torch.from_numpy(x), torch.from_numpy(y),
                            theta=th)
        want = jops.nlj_count(jnp.asarray(x), jnp.asarray(y), theta=th,
                              impl=impl)
        assert got.dtype == torch.int32 and got.shape == (B,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    mask = ops.nlj_mask(torch.from_numpy(x), torch.from_numpy(y), theta=theta)
    jmask = jops.nlj_mask(jnp.asarray(x), jnp.asarray(y), theta=theta,
                          impl=impl)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    if d > 0:
        np.testing.assert_array_equal(mask.sum(1).numpy(),
                                      ops.nlj_count(torch.from_numpy(x),
                                                    torch.from_numpy(y),
                                                    theta=theta).numpy())


def test_nlj_count_plain_version_blocks_queries():
    """The plain version counts in query blocks; any block size gives the
    one-block counts, and it launches no kernel."""
    rng = _rng("nlj-blocks")
    x = torch.from_numpy(rng.normal(size=(37, 16)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(50, 16)).astype(np.float32))
    before = ops.launch_counts()
    whole = ref.nlj_count(x, y, 5.0)
    for elems in (1, 50, 333, 10**6):
        assert torch.equal(ref.nlj_count(x, y, 5.0, block_elems=elems), whole)
    assert torch.equal(whole, ops.nlj_count(x, y, theta=5.0))
    assert torch.equal(whole, (ref.pairwise_sq_dists(x, y) < 25.0).sum(
        1, dtype=torch.int32))
    assert ops.launch_counts() == before
