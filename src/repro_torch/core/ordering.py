"""MST query ordering for work sharing (port of ``repro.core.ordering``;
paper §2.2.3, Alg. 1 line 2).

SIMJOIN builds a minimum spanning tree over the query index G_X, plus a
star of edges from the data index's navigating point s_Y to every query
(connectivity, and a fallback parent for far-away queries). Parents run
before children, so a child can seed from its parent's cached results.

The reference runs Prim's loop as a jitted ``fori_loop`` on the device.
Here the star keys and the G_X edge lengths are computed on the index's
device (the rowwise and gather distance kernels on the card), the (n, R)
edge table is fetched once, and Prim's n steps run in numpy with the
reference's rules: the first minimum wins ``argmin``, a key only drops
on a strictly shorter edge, and the G_X edges are the directed rows of
its neighbor table. The tree equals the reference's whenever the edge
lengths do.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import NO_NODE, GraphIndex
from repro_torch.kernels import ops


def _prim(key: np.ndarray, nbrs: np.ndarray, edge_d: np.ndarray
          ) -> np.ndarray:
    """Prim's MST from the star keys ``key`` (n,) = dist(x_i, s_Y) over
    the directed G_X edges ``nbrs`` (n, R) of lengths ``edge_d`` (+inf at
    NO_NODE). Returns parent[i] ∈ {-1} ∪ [0, n), -1 meaning s_Y."""
    n = key.shape[0]
    key = key.astype(np.float32).copy()
    parent = np.full(n, NO_NODE, np.int32)
    in_tree = np.zeros(n, bool)
    masked = key.copy()                   # key, +inf once in the tree
    for _ in range(n):
        u = int(np.argmin(masked))
        in_tree[u] = True
        masked[u] = np.inf
        vids, vd = nbrs[u], edge_d[u]
        vc = np.maximum(vids, 0)
        upd = (vids != NO_NODE) & ~in_tree[vc] & (vd < key[vc])
        v = vids[upd]
        key[v] = vd[upd]
        masked[v] = vd[upd]
        parent[v] = u
    return parent


def mst_order(index_x: GraphIndex, sy_vec: torch.Tensor) -> np.ndarray:
    """MST parents for every query (−1 ⇒ parent is s_Y)."""
    xv, nbrs = index_x.vecs, index_x.nbrs
    n = xv.shape[0]
    if n == 0:
        return np.zeros(0, np.int32)
    sy = sy_vec.to(device=xv.device, dtype=torch.float32).reshape(1, -1)
    key = ops.rowwise_sq_dists(sy, xv[None])[0]            # star edges
    edge_d = ops.gather_sq_dists(xv, xv, nbrs)            # +inf at NO_NODE
    return _prim(key.cpu().numpy(), nbrs.cpu().numpy(),
                 edge_d.cpu().numpy())


def wavefronts(parent: np.ndarray, wave_size: int) -> list[np.ndarray]:
    """Group queries by MST depth; chunk each level to ≤ wave_size.

    Returns a list of int arrays of query ids; every query's parent appears
    in a strictly earlier wave (or is s_Y).
    """
    n = parent.shape[0]
    level = np.full(n, -1, np.int64)
    roots = np.flatnonzero(parent < 0)
    level[roots] = 0
    children: dict[int, list[int]] = {}
    for i in range(n):
        p = parent[i]
        if p >= 0:
            children.setdefault(int(p), []).append(i)
    frontier = roots
    lv = 0
    while frontier.size:
        lv += 1
        nxt: list[int] = []
        for u in frontier:
            nxt.extend(children.get(int(u), ()))
        frontier = np.asarray(nxt, np.int64)
        level[frontier] = lv
    assert (level >= 0).all(), "MST parent array is not a spanning forest"
    waves: list[np.ndarray] = []
    for ell in range(level.max() + 1 if n else 0):
        ids = np.flatnonzero(level == ell)
        for c0 in range(0, ids.size, wave_size):
            waves.append(ids[c0:c0 + wave_size])
    return waves
