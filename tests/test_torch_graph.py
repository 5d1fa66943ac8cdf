"""Index build of the PyTorch port against the JAX package.

On the shared ``ds_manifold`` data (k = 32, degree = 16): the exact kNN
lists agree up to distance ties judged in float64, and the merged index
has equal neighbor tables and navigating node and an allclose
``mean_nbr_dist`` (rtol 1e-5: its L2 sums run in another order).
"""
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro_torch.core import graph
from repro_torch.core.types import NO_NODE

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the port's CPU tests run many small ops, and
    with the suite's parallel workers on every core, thread-pool regions
    waiting for descheduled threads slow them tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _merged_vecs(ds):
    return np.concatenate([ds.Y, ds.X], axis=0)


def test_exact_knn_matches_jax_up_to_ties(ds_manifold):
    vecs = _merged_vecs(ds_manifold)
    k = 32
    gd, gi = graph.exact_knn(torch.from_numpy(vecs), k)
    wd, wi = jgraph.exact_knn(vecs, k)
    gi, gd = gi.numpy(), gd.numpy()
    assert gi.dtype == np.int32 and gd.dtype == np.float32
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5)
    rows = np.flatnonzero((gi != wi).any(axis=1))
    # a differing row may only swap members tied in float64
    v64 = vecs.astype(np.float64)
    for r in rows:
        d_got = np.sort(((v64[gi[r]] - v64[r]) ** 2).sum(1))
        d_want = np.sort(((v64[wi[r]] - v64[r]) ** 2).sum(1))
        np.testing.assert_allclose(d_got, d_want, rtol=1e-6)
    assert rows.size <= 2, f"{rows.size} rows differ"


@pytest.mark.parametrize("block", [(4096, 65536), (100, 333)])
def test_exact_knn_blocking_invariant(ds_manifold, block):
    vecs = torch.from_numpy(ds_manifold.Y[:700])
    d0, i0 = graph.exact_knn(vecs, 16, qblock=700, dblock=700)
    d1, i1 = graph.exact_knn(vecs, 16, qblock=block[0], dblock=block[1])
    assert torch.equal(i0, i1) and torch.equal(d0, d1)
    assert not (i0 == torch.arange(700)[:, None]).any()     # self excluded


def test_build_merged_index_matches_jax(ds_manifold, index_merged):
    got = graph.build_merged_index(ds_manifold.Y, ds_manifold.X, k=32,
                                   degree=16, device=CPU)
    assert got.n_data == index_merged.n_data
    assert int(got.start) == int(index_merged.start)
    assert got.nbrs.dtype == torch.int32
    np.testing.assert_array_equal(got.nbrs.numpy(),
                                  np.asarray(index_merged.nbrs))
    np.testing.assert_allclose(got.mean_nbr_dist.numpy(),
                               np.asarray(index_merged.mean_nbr_dist),
                               rtol=1e-5)


def test_add_reverse_edges_matches_reference_loop():
    rng = np.random.default_rng(3)
    n, R = 300, 8
    table = np.full((n, R), NO_NODE, np.int32)
    for u in range(n):
        m = rng.integers(1, R + 1)
        table[u, :m] = rng.choice(np.delete(np.arange(n), u), m,
                                  replace=False)
    want = jgraph._add_reverse_edges(table.copy())
    got = graph._add_reverse_edges(torch.from_numpy(table.copy()),
                                   chunk=97)
    np.testing.assert_array_equal(got.numpy(), want)


def test_repair_connectivity_matches_reference():
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(200, 6)).astype(np.float32)
    table = np.full((200, 4), NO_NODE, np.int32)
    table[:150, 0] = (np.arange(150) + 1) % 150   # a ring; 150.. unreachable
    table[:20, 1] = 170                            # then one spoke
    want = jgraph._repair_connectivity(vecs, table.copy(), 0, None)
    got = graph._repair_connectivity(torch.from_numpy(vecs),
                                     torch.from_numpy(table.copy()), 0, None)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(graph._reachable(got, 0).numpy(),
                                  jgraph._reachable(want, 0))


def test_nsw_style_and_quant_guard(ds_manifold):
    Y = torch.from_numpy(ds_manifold.Y[:400])
    idx = graph.build_index(Y, k=16, degree=8, style="nsw")
    want = jgraph.build_index(ds_manifold.Y[:400], k=16, degree=8,
                              style="nsw")
    np.testing.assert_array_equal(idx.nbrs.numpy(), np.asarray(want.nbrs))
    # a mode without an int8 tier builds in f32, as the reference maps it
    f32 = graph.build_index(Y, k=16, degree=8)
    pdx8 = graph.build_index(Y, k=16, degree=8, quant="pdx8")
    assert torch.equal(pdx8.nbrs, f32.nbrs)
