"""The MST query order of the PyTorch port against the JAX package.

``repro_torch.core.ordering`` computes the star keys and G_X edge lengths
with the port's distance ops, then runs Prim's loop in numpy. On the same
query index (built by the reference and carried across unchanged) its
parent array and its wavefronts must equal the reference's exactly: the
join parity tests of the caching methods rely on the same wave order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_index as jbuild_index
from repro.core import ordering as jordering
from repro_torch.core import ordering
from repro_torch.core.types import NO_NODE, graph_index_from_numpy

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


def _port_index(jidx):
    return graph_index_from_numpy(
        np.asarray(jidx.vecs), np.asarray(jidx.nbrs), np.asarray(jidx.start),
        np.asarray(jidx.mean_nbr_dist), jidx.n_data, CPU)


@pytest.fixture(scope="module")
def small_case():
    """The reference's ordering test case: 80 queries, d = 12."""
    rng = np.random.default_rng(11)
    X = rng.normal(size=(80, 12)).astype(np.float32)
    sy = rng.normal(size=(12,)).astype(np.float32)
    return jbuild_index(jnp.asarray(X), k=16, degree=10), sy


@pytest.fixture(scope="module")
def cases(small_case, index_x, index_y):
    """(reference G_X, s_Y vector) for the small case and for the join
    fixtures (G_X of ds_manifold's queries, s_Y the medoid of G_Y)."""
    sy = np.asarray(index_y.vecs)[int(index_y.start)]
    return {"small": small_case, "manifold": (index_x, sy)}


@pytest.mark.parametrize("name", ["small", "manifold"])
def test_mst_parents_equal_jax(cases, name):
    jidx, sy = cases[name]
    want = np.asarray(jordering.mst_order(jidx, jnp.asarray(sy)))
    got = ordering.mst_order(_port_index(jidx), torch.tensor(sy))
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (got == NO_NODE).any()              # some queries hang off s_Y


@pytest.mark.parametrize("wave_size", [7, 48])
@pytest.mark.parametrize("name", ["small", "manifold"])
def test_wavefronts_equal_jax(cases, name, wave_size):
    jidx, sy = cases[name]
    parent = np.asarray(jordering.mst_order(jidx, jnp.asarray(sy)))
    want = jordering.wavefronts(parent, wave_size)
    got = ordering.wavefronts(parent, wave_size)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["small", "manifold"])
def test_parent_runs_before_child(cases, name):
    jidx, sy = cases[name]
    parent = ordering.mst_order(_port_index(jidx), torch.tensor(sy))
    waves = ordering.wavefronts(parent, wave_size=16)
    pos = {int(q): wi for wi, wave in enumerate(waves) for q in wave}
    n = parent.shape[0]
    assert sorted(pos) == list(range(n))              # every query once
    assert all(len(w) <= 16 for w in waves)
    for q in range(n):
        if parent[q] >= 0:
            assert pos[int(parent[q])] < pos[q], (q, parent[q])


def test_mst_on_a_hand_made_graph():
    """On a hand-made graph: the parents form a tree rooted at s_Y, and a
    query joins through a G_X edge only when it is shorter than its star
    edge; an empty query set gives no parents and no waves."""
    # points on a line; s_Y at 0; G_X edges between neighbours only
    xs = np.array([[1.0], [2.0], [10.0], [11.5], [3.0]], np.float32)
    nbrs = np.array([[1, -1], [0, 4], [3, -1], [2, -1], [1, -1]], np.int32)
    idx = graph_index_from_numpy(xs, nbrs, 0, np.zeros(5, np.float32), 5,
                                 CPU)
    parent = ordering.mst_order(idx, torch.zeros(1))
    # squared star keys 1, 4, 100, 132.25, 9: 0 hangs off s_Y, 1 off 0
    # (edge 1 < 4), 4 off 1 (1 < 9), 2 off s_Y (no edge to 0, 1 or 4),
    # 3 off 2 (2.25 < 132.25)
    np.testing.assert_array_equal(parent, [-1, 0, -1, 2, 1])
    assert ordering.wavefronts(parent, 2)[0].tolist() == [0, 2]
    empty = graph_index_from_numpy(np.zeros((0, 3), np.float32),
                                   np.zeros((0, 2), np.int32), 0,
                                   np.zeros(0, np.float32), 0, CPU)
    assert ordering.mst_order(empty, torch.zeros(3)).shape == (0,)
    assert ordering.wavefronts(np.zeros(0, np.int32), 4) == []
