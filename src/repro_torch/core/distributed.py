"""The sharded join over a mesh of torch devices (port of
``repro.core.distributed``).

A threshold join decomposes exactly over data partitions:
``X ⋈_θ Y = ∪_s (X ⋈_θ Y_s)``, so recall composes additively and no
cross-shard traffic is needed during traversal. ``MeshPlan`` picks, per
(N_y, d, shards), between two partitionings of that decomposition:

  * **vector partitioning**: Y's rows (and the per-shard merged indexes
    G_{X∪Y_s}) split over the ``data`` axis, whole vectors on every
    shard. The only layout the graph traversal can use.
  * **hybrid dimension+vector partitioning** (exact NLJ only): a second
    ``model`` axis splits the dimensions into whole 64-wide PDX slab
    groups; the groups' partial squared distances are combined by
    ``psum``, and any rank may retire a lane on its certified tail bound
    (``hybrid_tail_bound``).

One controller process drives every shard, as the reference's
``shard_map`` does. ``DeviceMesh`` stands in for ``jax.sharding.Mesh``:
an ordered tuple of ``torch.device``s with a shape and axis names; one
device may hold several logical shards (``DeviceMesh.on_device``), the
counterpart of the reference's forced host devices. Each shard's block
lives on its own device, and the collectives are plain functions with
the reference's semantics: ``all_gather`` copies every shard's block to
the assembling device and stacks them in rank order, ``psum`` sums the
partials in rank order. Only the assembling device reads the combined
pool, so the pool is always combined by ``all_gather``;
``MeshPlan.pool_combine`` is the reference's choice of collective and
only routes the byte meters (``bytes_allgather``/``bytes_ppermute``
count the reference's per-rank traffic, not the port's copies). The
host steps the shards' traversal loops one shard after another within a
wave (the reference runs them in parallel inside one compiled step).

Uneven shards: Y is padded to ``shard_size · n_shards`` rows with
far-away (1e3) sentinels. They are masked out of every per-shard scale,
center and variance statistic, pre-visited in the traversal bitmap, and
can never satisfy ``d² < θ²``, so the pairs are those of the unpadded
join.
"""
from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from repro_torch.core import traversal
from repro_torch.core.types import (NO_NODE, GraphIndex, JoinStats,
                                    TraversalConfig, early_exit_enabled,
                                    resolve_device)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import sq_norms
from repro_torch.obs import trace as obs_trace

# MeshPlan's decision rule (the reference's constants): hybrid partitioning
# pays only when every model rank owns at least one whole PDX slab and
# vector partitioning alone leaves fewer than HYBRID_ROW_FLOOR rows a shard
HYBRID_ROW_FLOOR = 4096
POOL_COMBINE_RING_MIN = 8  # the reference's ppermute ring from here up
DEFAULT_MERGE_CAP = 32     # cold-start kept-pairs/lane/shard capacity
NLJ_COUNT_WAVE = 256       # queries a wave of make_distributed_nlj_count


def visible_devices(device=None) -> int:
    """How many devices a plan may spread over when no mesh is given: the
    visible CUDA devices for a CUDA (or unnamed) device, one for a CPU."""
    if device is not None and torch.device(device).type != "cuda":
        return 1
    return torch.cuda.device_count()


# ---------------------------------------------------------------------------
# the device mesh and its collectives
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """An ordered tuple of torch devices laid out row-major over ``shape``
    with one name per axis (the port's ``jax.sharding.Mesh``). A device
    may appear more than once: each entry is one logical shard."""
    devices: tuple
    shape: tuple
    axis_names: tuple = ("data",)

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axis names "
                             f"{self.axis_names} differ in rank")
        if int(np.prod(self.shape)) != len(devs) or not devs:
            raise ValueError(f"{len(devs)} device(s) do not fill a mesh of "
                             f"shape {self.shape}")

    @classmethod
    def of(cls, devices, shape=None, axis_names=("data",)) -> "DeviceMesh":
        """A mesh over ``devices`` (a 1-D data axis unless ``shape``)."""
        devices = tuple(devices)
        return cls(devices, shape or (len(devices),), axis_names)

    @classmethod
    def on_device(cls, device, n: int, shape=None,
                  axis_names=("data",)) -> "DeviceMesh":
        """``n`` logical shards on one device (the CPU tests' ``"cpu"``,
        the smoke's ``"cuda:0"``)."""
        return cls.of((torch.device(device),) * int(n), shape, axis_names)

    @property
    def size(self) -> int:
        return len(self.devices)

    def _axes(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"mesh has no axis {a!r} "
                                 f"(axes {self.axis_names})")
        return axes

    def axis_size(self, axes) -> int:
        return int(np.prod([self.shape[self.axis_names.index(a)]
                            for a in self._axes(axes)]))

    def device_at(self, **coords) -> torch.device:
        """The device at the given axis coordinates (0 on the others)."""
        idx = [int(coords.get(a, 0)) for a in self.axis_names]
        return self.devices[int(np.ravel_multi_index(idx, self.shape))]

    def shard_devices(self, axes) -> tuple:
        """One device per shard index over the shard ``axes``, the index
        flattened row-major over them (``("pod", "data")`` on a
        ``(pod, data, model)`` mesh), coordinate 0 on every other axis."""
        axes = self._axes(axes)
        sizes = [self.shape[self.axis_names.index(a)] for a in axes]
        out = []
        for flat in range(int(np.prod(sizes))):
            coords = dict(zip(axes, np.unravel_index(flat, sizes)))
            out.append(self.device_at(**coords))
        return tuple(out)


def all_gather(blocks, device) -> torch.Tensor:
    """Every shard's block copied to ``device`` and stacked in rank order:
    the (S, …) block the reference's ``all_gather`` gives each rank."""
    return torch.stack([b.to(device) for b in blocks])


def psum(parts, device) -> torch.Tensor:
    """The partials copied to ``device`` and summed in rank order (the
    order ``torch.stack(parts).sum(0)`` takes, bit for bit)."""
    return torch.stack([p.to(device) for p in parts]).sum(0)


# ---------------------------------------------------------------------------
# MeshPlan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """How many devices go to rows and how many to dimensions, and which
    collective merges the pair pool (``repro.core.distributed.MeshPlan``).

    Graph-traversal methods always get vector partitioning
    (``dim_shards == 1``); the exact NLJ may move factors of two from the
    ``data`` axis to the ``model`` axis while the rows a shard are under
    ``HYBRID_ROW_FLOOR`` and each model rank still owns a whole PDX slab.
    The pool combine is the reference's collective, ``all_gather`` for
    small shard groups and its ``ppermute`` ring from
    ``POOL_COMBINE_RING_MIN`` up; the port combines with ``all_gather``
    either way, and the label routes the byte meters."""
    n_shards: int
    dim_shards: int = 1
    data_axis: str = "data"
    model_axis: str = "model"
    pool_combine: str = "all_gather"

    def __post_init__(self):
        if self.pool_combine not in ("all_gather", "ppermute"):
            raise ValueError(f"unknown pool combine {self.pool_combine!r}")

    @property
    def kind(self) -> str:
        return "vector" if self.dim_shards == 1 else "hybrid"

    @property
    def n_devices(self) -> int:
        return self.n_shards * self.dim_shards

    def make_mesh(self, devices=None) -> DeviceMesh:
        """The plan's mesh over ``devices`` (a ``DeviceMesh`` or a sequence
        of devices holding exactly ``n_devices``; the visible CUDA devices
        when omitted)."""
        if devices is None:
            devices = [torch.device("cuda", i) for i in range(self.n_devices)]
        elif isinstance(devices, DeviceMesh):
            devices = devices.devices
        devices = tuple(devices)[:self.n_devices]
        if len(devices) != self.n_devices:
            raise ValueError(f"plan needs {self.n_devices} device(s), got "
                             f"{len(devices)}")
        if self.dim_shards == 1:
            return DeviceMesh(devices, (self.n_shards,), (self.data_axis,))
        return DeviceMesh(devices, (self.n_shards, self.dim_shards),
                          (self.data_axis, self.model_axis))

    @classmethod
    def plan(cls, n_y: int, d: int, shards, *, devices: int | None = None,
             traversal: bool = True, pool_combine: str | None = None
             ) -> "MeshPlan":
        """Resolve ``shards`` (an int; 0, ``"auto"`` or None = all devices)
        into a partitioning of an (N_y, d) data side. ``devices`` is the
        number of devices to spread over (the visible CUDA devices when
        None). Raises a clear ``ValueError`` when more shards are asked
        for than there are devices."""
        from repro_torch.quant.pdx import DEFAULT_SLAB

        if devices is None:
            devices = visible_devices()
        if shards in (0, "auto", None):
            shards = devices
        shards = int(shards)
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if shards > devices:
            raise ValueError(
                f"{shards} shard(s) requested but only {devices} "
                f"device(s) visible; use --shards auto, or give a "
                f"DeviceMesh that holds {shards} shards (several may share "
                f"one device: --device cpu,cpu,... or cuda:0,cuda:0,...)")
        k = 1
        if not traversal:
            while (shards % (k * 2) == 0 and shards // (k * 2) >= 1
                   and d // (k * 2) >= DEFAULT_SLAB
                   and n_y // (shards // k) < HYBRID_ROW_FLOOR):
                k *= 2
        n_shards = shards // k
        if pool_combine is None:
            pool_combine = ("ppermute" if n_shards >= POOL_COMBINE_RING_MIN
                            else "all_gather")
        return cls(n_shards=n_shards, dim_shards=k, pool_combine=pool_combine)


# ---------------------------------------------------------------------------
# per-shard merged indexes and tier stores
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedMergedIndex:
    """Per-shard merged indexes G_{X∪Y_s}, shard s on its own device; each
    holds ``shard_size`` data rows (the last one padded with sentinels)
    followed by the ``n_query`` query nodes."""
    shards: tuple
    shard_size: int
    n_query: int

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def devices(self) -> tuple:
        return tuple(g.device for g in self.shards)


def _as_f32(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def build_sharded_merged_index(Y, X, n_shards: int, *, devices=None,
                               **build_kw) -> ShardedMergedIndex:
    """One merged index per Y-shard, shard s built on ``devices[s]`` by
    ``graph.build_merged_index`` (``devices``: a sequence of S devices,
    by default S times Y's device, or the card for arrays)."""
    from repro_torch.core import graph

    if devices is None:
        dev = (Y.device if isinstance(Y, torch.Tensor)
               else resolve_device(None))
        devices = (dev,) * n_shards
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != n_shards:
        raise ValueError(f"{n_shards} shards need {n_shards} devices, got "
                         f"{len(devices)}")
    n, d = Y.shape
    shard_size = -(-n // n_shards)
    shards = []
    for s, dev in enumerate(devices):
        ys = _as_f32(Y[s * shard_size:min((s + 1) * shard_size, n)], dev)
        if ys.shape[0] < shard_size:
            # far-away sentinel rows that can never join
            ys = torch.cat([ys, torch.full((shard_size - ys.shape[0], d),
                                           1e3, device=dev)])
        shards.append(graph.build_merged_index(ys, _as_f32(X, dev),
                                               **build_kw))
    return ShardedMergedIndex(shards=tuple(shards), shard_size=shard_size,
                              n_query=int(X.shape[0]))


@dataclasses.dataclass(frozen=True)
class ShardedTierStore:
    """The per-shard stores behind one cascade tier (``stores[s]`` on shard
    s's device). ``shared`` names the fields every shard's store holds
    alike (the sketch's rotation, isometry factor and checkpoint grid):
    counted once in ``nbytes``, as the reference replicates them."""
    name: str
    stores: tuple
    shared: tuple = ()

    @property
    def nbytes(self) -> int:
        dup = sum(getattr(self.stores[0], f).numel()
                  * getattr(self.stores[0], f).element_size()
                  for f in self.shared)
        return sum(s.nbytes for s in self.stores) - dup * (len(self.stores)
                                                            - 1)


def _scale_masks(smi: ShardedMergedIndex, n_data: int | None) -> list:
    """Per-shard ``scale_rows`` masks: all rows but the last shard's
    sentinel pad rows (None where nothing is masked)."""
    S = smi.n_shards
    pad = S * smi.shard_size - n_data if n_data is not None else 0
    masks = [None] * S
    if pad:
        m = np.ones(smi.shards[-1].n_nodes, bool)
        m[smi.shard_size - pad:smi.shard_size] = False
        masks[-1] = m
    return masks


def quantize_sharded(smi: ShardedMergedIndex, *, n_data: int | None = None,
                     group_size: int | None = None) -> ShardedTierStore:
    """One int8 ``QuantStore`` per shard, each on its own scale grid; the
    last shard's sentinel rows (``n_data`` = the unpadded |Y|) set no
    scale but are quantized (they clip; their exact ``err`` keeps the
    bounds sound)."""
    from repro_torch.quant import store as qstore

    gs = group_size or qstore.DEFAULT_GROUP_SIZE
    return ShardedTierStore("int8", tuple(
        qstore.build_store(g.vecs, group_size=gs, scale_rows=m)
        for g, m in zip(smi.shards, _scale_masks(smi, n_data))))


def sketch_sharded(smi: ShardedMergedIndex, *, n_data: int | None = None,
                   seed: int = 0) -> ShardedTierStore:
    """One ``SketchStore`` per shard, each on its own center μ_s (the
    sentinel rows masked out of it); the rotation depends only on
    (d, seed) and is computed once for every shard."""
    from repro_torch.quant import sketch as sk

    d = smi.shards[0].vecs.shape[1]
    rotation = sk.make_rotation(d, seed)
    return ShardedTierStore("sketch1", tuple(
        sk.build_sketch(g.vecs, seed=seed, scale_rows=m, rotation=rotation)
        for g, m in zip(smi.shards, _scale_masks(smi, n_data))),
        shared=("hs", "rot", "iso"))


def pdx_sharded(smi: ShardedMergedIndex, *, n_data: int | None = None,
                slab: int | None = None) -> ShardedTierStore:
    """One ``PdxStore`` per shard, each with its own variance order and
    slab grid (the sentinel rows masked out of both)."""
    from repro_torch.quant import pdx as pdx_mod

    sl = slab or pdx_mod.DEFAULT_SLAB
    return ShardedTierStore("pdx", tuple(
        pdx_mod.build_pdx(g.vecs, slab=sl, scale_rows=m)
        for g, m in zip(smi.shards, _scale_masks(smi, n_data))))


def build_sharded_tier(name: str, smi: ShardedMergedIndex, *,
                       n_data: int | None = None) -> ShardedTierStore:
    """The per-shard stores behind one cascade tier, the sharded mirror of
    ``quant.cascade.build_tier_store`` (same names)."""
    if name == "int8":
        return quantize_sharded(smi, n_data=n_data)
    if name == "sketch1":
        return sketch_sharded(smi, n_data=n_data)
    if name == "pdx":
        return pdx_sharded(smi, n_data=n_data)
    raise ValueError(f"unknown sharded tier {name!r}")


@dataclasses.dataclass(frozen=True)
class ShardedCascade:
    """Per-shard tier stores assembled like a ``FilterCascade``; each
    shard's body rebuilds its local cascade (``_local_cascade``)."""
    names: tuple
    stores: tuple          # ShardedTierStore per name, aligned

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.stores)

    def store(self, name: str):
        return (self.stores[self.names.index(name)]
                if name in self.names else None)


def _local_cascade(cascade: ShardedCascade | None, s: int):
    """Shard ``s``'s own ``FilterCascade`` from its slice of each tier."""
    from repro_torch.quant.cascade import make_cascade

    if cascade is None:
        return None
    return make_cascade([(n, st.stores[s])
                         for n, st in zip(cascade.names, cascade.stores)])


# ---------------------------------------------------------------------------
# the mesh MI join
# ---------------------------------------------------------------------------

def _sentinel_bits(n_words: int, lo: int, hi: int,
                   device) -> torch.Tensor:
    """(n_words,) int32 bitmap row with the bits of node ids [lo, hi)."""
    ids = torch.arange(lo, hi, dtype=torch.int32, device=device)
    row = torch.zeros((n_words,), dtype=torch.int32, device=device)
    row.scatter_add_(0, (ids >> 5).long(), traversal.bit_of(ids))
    return row


def _local_mi_join(index: GraphIndex, cascade, xw: torch.Tensor,
                   qids: torch.Tensor, lane_valid: torch.Tensor, *,
                   rank: int, last: bool, theta: float, cfg: TraversalConfig,
                   shard_size: int, hybrid: bool, pad_last: int,
                   rerank_cap: int, early_exit: bool, merge_cap: int,
                   n_steps: int | None = None):
    """One shard's wave of the MI join (the reference's per-shard body).

    Probes each query's own row of the shard's merged index, runs BFS (or
    the hybrid BBFS), and under a cascade re-ranks the pool's ambiguous
    band in-shard through a ``rerank_cap``-wide compaction, as the
    single-device epilogue does. The kept ids are globalized
    (``pool_idx + rank · shard_size``) and band-compacted into
    ``merge_cap`` columns. Returns ``(cand (B, merge_cap) int32, stats,
    n_iters)``: ``stats`` the int32 per-lane ``n_keep``, ``overflow``,
    ``n_dist``, ``n_rerank``, ``n_esc``, ``n_band_over`` and the 0-d
    ``n_dims_scanned``, ``n_dims_total`` of the PDX re-rank; ``n_iters``
    the expansion's host-stepped iterations. Lanes whose kept set
    outgrows ``merge_cap`` report it in ``n_keep`` (the driver retries);
    so do band overflows in ``n_band_over``. ``n_steps`` runs exactly that
    many expansion iterations with no host sync (``range_expand``)."""
    from repro_torch.engine import waves as W

    dev = xw.device
    B = xw.shape[0]
    qc = cascade.encode(xw) if cascade is not None else None
    th2 = traversal.sq_theta(theta)
    visited = torch.zeros((B, traversal.bitmap_words(index.n_nodes)),
                          dtype=torch.int32, device=dev)
    if pad_last and last:
        # the last shard's sentinel pad rows are pre-visited, so they are
        # never probed or pooled (their clipped int8 codes carry a huge
        # exact err: lower bounds of 0 that would flood the pool)
        visited += _sentinel_bits(visited.shape[1], shard_size - pad_last,
                                  shard_size, dev)[None, :]
    rows, dist, ub, valid, visited, n_new, n_esc0, best, besti = W._mi_probe(
        index, xw, qids + shard_size, lane_valid, traverse_nondata=hybrid,
        dist_impl=cfg.dist_impl, cascade=cascade, qc=qc, esc_th2=th2,
        visited=visited)
    r = traversal.range_expand(
        index, xw, theta, cfg=cfg, n_data=shard_size, hybrid=hybrid,
        traverse_nondata=hybrid, init_idx=rows, init_dist=dist,
        init_valid=valid, visited=visited, best_dist=best, best_idx=besti,
        n_dist=n_new, cascade=cascade, qc=qc, init_ub=ub, n_esc=n_esc0,
        n_steps=n_steps)
    C = r.pool_idx.shape[1]
    keep = torch.arange(C, device=dev)[None, :] < r.n_pool[:, None]
    zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
    n_rerank = n_band_over = zeros
    n_scanned = n_total = torch.zeros((), dtype=torch.int32, device=dev)
    if cascade is not None:
        sure, amb = cascade.pool_band(qc, r.pool_dist, r.pool_idx, th2)
        sure = keep & sure
        amb = keep & amb
        n_rerank = torch.sum(amb, dim=1, dtype=torch.int32)
        cap = min(rerank_cap, C) if rerank_cap > 0 else C
        pdx = cascade.tier("pdx")
        if pdx is not None:
            # the band re-rank through the PDX gather (#11′) on the shard's
            # own PDX mirror; +inf where it retired a lane (certified ≥ θ²)
            st = pdx.store
            qcp = qc[cascade.names.index("pdx")]
            exact, within, _, n_scanned, n_total = \
                ops.pdx_compact_gather_sq_dists(
                    st.vp, st.ftail, st.ftail[:, 0].contiguous(), qcp.vp,
                    qcp.ftail, qcp.ftail[:, 0].contiguous(), r.pool_idx, amb,
                    cap, th2, dim=st.dim, early_exit=early_exit,
                    impl=cfg.dist_impl)
        else:
            exact, within, _ = ops.compact_gather_sq_dists(
                index.vecs, xw, r.pool_idx, amb, cap, impl=cfg.dist_impl)
        keep = sure | (within & (exact < th2))
        n_band_over = torch.sum(amb & ~within, dim=1, dtype=torch.int32)
    kept = keep & lane_valid[:, None] & (r.pool_idx != NO_NODE)
    gids = torch.where(kept, r.pool_idx + rank * shard_size, NO_NODE)
    n_keep = torch.sum(kept, dim=1, dtype=torch.int32)
    _, cand, _ = ops.band_compact(kept, gids.to(torch.int32), merge_cap)
    i32 = torch.int32
    stats = (n_keep, r.overflow.to(i32), r.n_dist.to(i32), n_rerank,
             r.n_esc.to(i32), n_band_over, n_scanned.to(i32),
             n_total.to(i32))
    return cand, stats, r.n_iters


def make_distributed_mi_join(mesh: DeviceMesh, shard_axes,
                             smi: ShardedMergedIndex, *, theta: float,
                             cfg: TraversalConfig, hybrid: bool = False,
                             cascade: ShardedCascade | None = None,
                             n_data: int | None = None,
                             rerank_cap: int | None = None,
                             merge_cap: int = DEFAULT_MERGE_CAP):
    """The per-wave step of the mesh MI join.

    ``shard_axes`` names the mesh axis (or axes, flattened row-major) the
    index is sharded over; the mesh must hold exactly one shard per index
    shard. ``cascade`` puts each shard on its local tier chain; ``n_data``
    (the unpadded |Y|) lets the last shard hide its sentinel rows;
    ``rerank_cap`` overrides ``cfg.rerank_cap``. Returns ``step(xw, qids,
    lane_valid) → (outs, n_iters)``: ``xw`` the (B, d) wave, ``qids`` the
    (B,) int32 query ids and ``lane_valid`` the (B,) bool lanes (host
    arrays or tensors); ``outs`` the combined (S, B, merge_cap) id block
    and the (S, B) / (S,) per-shard stats on the assembling device (the
    first shard's), ``n_iters`` the shards' host-stepped iterations."""
    axes = (shard_axes,) if isinstance(shard_axes, str) else tuple(shard_axes)
    axis_size = mesh.axis_size(axes)
    if smi.n_shards != axis_size:
        raise ValueError(f"index has {smi.n_shards} shards but mesh axes "
                         f"{axes} provide {axis_size} devices")
    names = cascade.names if cascade is not None else ()
    if "sketch1" in names and not ({"int8", "pdx"} & set(names)):
        raise ValueError("the sketch tier needs a confirming tier (int8 or "
                         "pdx)")
    S = smi.n_shards
    pad = S * smi.shard_size - n_data if n_data is not None else 0
    local = [_local_cascade(cascade, s) for s in range(S)]
    body = functools.partial(
        _local_mi_join, theta=theta, cfg=cfg, shard_size=smi.shard_size,
        hybrid=hybrid, pad_last=pad,
        rerank_cap=cfg.rerank_cap if rerank_cap is None else rerank_cap,
        early_exit=early_exit_enabled(cfg) if "pdx" in names else False,
        merge_cap=merge_cap)
    dst = smi.devices[0]

    def step(xw, qids, lane_valid):
        cands, per, n_iters = [], [], 0
        for s, index in enumerate(smi.shards):
            dev = index.device
            cand, stats, it = body(
                index, local[s], _as_f32(xw, dev),
                torch.as_tensor(np.asarray(qids), device=dev).to(torch.int32),
                torch.as_tensor(np.asarray(lane_valid), device=dev),
                rank=s, last=s == S - 1)
            cands.append(cand)
            per.append(stats)
            n_iters += it
        merged = all_gather(cands, dst)
        stacked = tuple(torch.stack([p[i].to(dst) for p in per])
                        for i in range(len(per[0])))
        return (merged,) + stacked, n_iters

    return step


def local_mi_iteration(index: GraphIndex, xw: torch.Tensor,
                       qids: torch.Tensor, lane_valid: torch.Tensor, *,
                       theta: float, cfg: TraversalConfig, shard_size: int,
                       hybrid: bool = False, rank: int = 0):
    """One shard's wave of the f32 mesh MI join cut to one traversal
    iteration, with no host sync: the probe of each query's merged-index
    row, ``expand_init`` and one ``expand_step``, and the band compaction
    of the kept pool into DEFAULT_MERGE_CAP columns; the vectors may be
    bf16
    (the gather's bf16 entry). This is the iteration the dry run traces on
    fake tensors and scales by a cell's expected iterations, as the
    reference lowers its step's ``while_loop`` body once. Returns
    ``(cand (B, DEFAULT_MERGE_CAP) int32, n_keep (B,) int32)``."""
    cand, stats, _ = _local_mi_join(
        index, None, xw, qids, lane_valid, rank=rank, last=False,
        theta=theta, cfg=cfg, shard_size=shard_size, hybrid=hybrid,
        pad_last=0, rerank_cap=cfg.rerank_cap, early_exit=False,
        merge_cap=DEFAULT_MERGE_CAP, n_steps=1)
    return cand, stats[0]


def mesh_mi_iteration(smi: ShardedMergedIndex, xw: torch.Tensor,
                      qids: torch.Tensor, lane_valid: torch.Tensor, *,
                      theta: float, cfg: TraversalConfig,
                      hybrid: bool = False) -> torch.Tensor:
    """``local_mi_iteration`` on every shard, one after another, and the
    kept pools combined on the first shard's device → (S, B,
    DEFAULT_MERGE_CAP)."""
    cands = [local_mi_iteration(
        index, xw.to(index.device), qids.to(index.device),
        lane_valid.to(index.device), theta=theta, cfg=cfg,
        shard_size=smi.shard_size, hybrid=hybrid, rank=s)[0]
        for s, index in enumerate(smi.shards)]
    return all_gather(cands, smi.devices[0])


def distributed_mi_join(X, smi: ShardedMergedIndex,
                        mesh: DeviceMesh | None = None, shard_axes=None, *,
                        theta: float, cfg: TraversalConfig,
                        wave_size: int = 256, hybrid: bool = False,
                        cascade: ShardedCascade | None = None,
                        n_data: int | None = None, overlap: bool = True,
                        plan: MeshPlan | None = None,
                        merge_cap: int = DEFAULT_MERGE_CAP,
                        rerank_cap_init: int | None = None):
    """Host driver of the mesh MI join: waves of queries against every
    shard, the pair pools combined on the devices, pairs assembled on the
    host (``repro.core.distributed.distributed_mi_join``).

    Pass ``(mesh, shard_axes)`` or a ``MeshPlan`` (which also picks the
    pool combine; its mesh is built over the index's shard devices when
    ``mesh`` is omitted). With ``overlap`` wave k+1 is dispatched before
    wave k is fetched and assembled; off, the same steps run in sequence.

    Two sticky grow-and-retry capacities keep the pairs independent of
    caps: the in-shard re-rank band (``RerankCap``) and the merged pool
    (kept pairs per lane per shard, ``StickyCap``). A wave that overflows
    either on any shard is re-dispatched at the grown caps, sticky for the
    rest of the call; merge overflow is judged against the fetched block's
    width, not the current cap, so a wave dispatched before an earlier
    wave's retry grew the cap is still caught. Work and byte meters count
    every attempt, retries included (each also bumps
    ``overflow_retries``). ``merge_cap``/``rerank_cap_init`` seed the caps.

    Returns ``(pairs, stats)``: one ``JoinStats`` per shard (its
    ``band_occ_per_shard`` the shard's band total), reduced with
    ``JoinStats.merge``. ``n_iters`` counts the host-stepped iterations
    of every shard (the reference's compiled loops report none)."""
    from repro_torch.engine import waves as W

    if plan is not None:
        if mesh is None:
            mesh = plan.make_mesh(smi.devices)
        if shard_axes is None:
            shard_axes = plan.data_axis
    if mesh is None or shard_axes is None:
        raise ValueError("pass mesh+shard_axes or a MeshPlan")
    pool_combine = plan.pool_combine if plan is not None else "all_gather"
    if isinstance(X, torch.Tensor):
        X = X.to(dtype=torch.float32)
    else:
        X = torch.as_tensor(np.asarray(X, np.float32), device=smi.devices[0])
    nq, d = int(X.shape[0]), int(X.shape[1])
    C = cfg.pool_cap
    S = smi.n_shards
    rcap = W.RerankCap(cfg, init_cap=rerank_cap_init)
    mcap = W.StickyCap(merge_cap, C)
    steps: dict[tuple, object] = {}

    def get_step():
        key = (rcap.cap if cascade is not None else C, mcap.cap)
        if key not in steps:
            steps[key] = make_distributed_mi_join(
                mesh, shard_axes, smi, theta=theta, cfg=cfg, hybrid=hybrid,
                cascade=cascade, n_data=n_data, rerank_cap=key[0],
                merge_cap=key[1])
        return steps[key]

    pairs_out = []
    shard_stats = [JoinStats() for _ in range(S)]
    band = np.zeros(S, np.int64)
    tr = obs_trace.tracer()

    def dispatch(padded, lane_valid):
        step = get_step()
        dev = tr.begin("wave/device", lane="traversal", cap=rcap.cap,
                       merge_cap=mcap.cap, shards=S)
        outs, n_iters = step(X[torch.as_tensor(padded, device=X.device)],
                             padded, lane_valid)
        B = int(lane_valid.shape[0])
        # the reference's peer payload a device; the label picks the meter
        combine_bytes = (S - 1) * B * mcap.cap * 4
        for st in shard_stats:
            if cascade is not None:
                st.n_rerank_gather += B * rcap.cap
                st.bytes_band += B * rcap.cap * d * 4
            if pool_combine == "ppermute":
                st.bytes_ppermute += combine_bytes
            else:
                st.bytes_allgather += combine_bytes
        shard_stats[0].n_iters += n_iters
        return outs, dev

    def fetch(outs, dev):
        """The blocking per-wave transfer: the combined pool block and
        the per-shard stats."""
        t0 = time.perf_counter()
        outs = tuple(o.cpu().numpy() for o in outs)
        if dev:
            dev.end()
        shard_stats[0].wait_seconds += time.perf_counter() - t0
        shard_stats[0].bytes_assembly += sum(a.nbytes for a in outs)
        return outs

    def assemble(wave) -> None:
        padded, lane_valid, outs, dev = wave

        def tally(n_dist, overflow, n_rerank, n_esc, n_dims_s, n_dims_t):
            # every attempt's work counts: a retry re-runs the whole wave
            per = {
                "n_dist": n_dist[:, lane_valid].sum(axis=1),
                "n_overflow": overflow[:, lane_valid].sum(axis=1),
                "n_rerank": n_rerank[:, lane_valid].sum(axis=1),
                "n_esc8": n_esc[:, lane_valid].sum(axis=1),
                "n_dims_scanned": np.asarray(n_dims_s).reshape(-1),
                "n_dims_total": np.asarray(n_dims_t).reshape(-1),
            }
            for s, st in enumerate(shard_stats):
                for k, v in per.items():
                    setattr(st, k, getattr(st, k) + int(v[s]))
            band[:] += n_rerank[:, lane_valid].sum(axis=1).astype(np.int64)

        with tr.span("wave/assemble", lane="assembly") as sp:
            (merged, n_keep, overflow, n_dist, n_rerank, n_esc,
             n_band_over, n_dims_s, n_dims_t) = fetch(outs, dev)
            tally(n_dist, overflow, n_rerank, n_esc, n_dims_s, n_dims_t)
            # grow and retry until neither the band nor the merged pool
            # overflows (caps are monotone powers of two up to pool_cap)
            while True:
                need_band = (int(n_rerank[:, lane_valid].max())
                             if n_band_over[:, lane_valid].sum() > 0 else 0)
                # against the fetched block's width: with overlap on, an
                # earlier wave's retry may have grown the sticky cap after
                # this wave was dispatched
                need_merge = (int(n_keep[:, lane_valid].max())
                              if (n_keep[:, lane_valid]
                                  > merged.shape[2]).any() else 0)
                if not need_band and not need_merge:
                    break
                if tr:
                    tr.instant("wave/overflow_retry", lane="traversal",
                               band=need_band, merge=need_merge,
                               cap=rcap.cap, merge_cap=mcap.cap)
                shard_stats[0].overflow_retries += 1
                if need_band:
                    rcap.grow(need_band)
                if need_merge:
                    mcap.grow(need_merge)
                (merged, n_keep, overflow, n_dist, n_rerank, n_esc,
                 n_band_over, n_dims_s, n_dims_t) = fetch(
                    *dispatch(padded, lane_valid))
                tally(n_dist, overflow, n_rerank, n_esc, n_dims_s, n_dims_t)
            t1 = time.perf_counter()
            # (S, B, K) merged block: every entry ≠ NO_NODE is a kept pair
            sh, ln, sl = np.nonzero(merged != NO_NODE)
            pairs_out.append(np.stack([padded[ln], merged[sh, ln, sl]],
                                      axis=1))
            if sp:
                sp.set(pairs=int(ln.size))
            shard_stats[0].other_seconds += time.perf_counter() - t1

    pending = None
    for q0 in range(0, nq, wave_size):
        ids = np.arange(q0, min(q0 + wave_size, nq))
        padded, lane_valid = W.pad_wave(ids.astype(np.int32), wave_size)
        outs, dev = dispatch(padded, lane_valid)
        if overlap:
            if pending is not None:
                assemble(pending)
            pending = (padded, lane_valid, outs, dev)
        else:
            assemble((padded, lane_valid, outs, dev))
    if pending is not None:
        assemble(pending)
    pairs = (np.concatenate(pairs_out, axis=0) if pairs_out
             else np.empty((0, 2), np.int64)).astype(np.int64)
    for s, st in enumerate(shard_stats):
        st.band_occ_per_shard = (int(band[s]),)
    stats = functools.reduce(JoinStats.merge, shard_stats)
    return pairs, stats


# ---------------------------------------------------------------------------
# the mesh NLJ: vector plans on #1, hybrid dimension+vector plans
# ---------------------------------------------------------------------------

def _pad_cols(A: torch.Tensor, k: int, slab: int) -> tuple[torch.Tensor, int]:
    """Zero-pad columns so ``k`` model ranks each own the same number of
    whole slabs (``w`` columns each). Zero columns add exactly 0.0 to
    every squared distance, so the padded results are the unpadded ones."""
    d = A.shape[1]
    n_slabs = -(-d // slab)
    w = -(-n_slabs // k) * slab             # whole slabs per model rank
    if w * k == d:
        return A.contiguous(), w
    return torch.nn.functional.pad(A, (0, w * k - d)), w


def _group_partial(x: torch.Tensor, y: torch.Tensor):
    """One model rank's partial: ``(xn + ynᵀ − 2·x@yᵀ, xn, yn)`` over its
    column group, the reference's arithmetic (a plain f32 matmul; the
    reference computes it outside any Pallas kernel)."""
    xn = torch.sum(x * x, dim=-1, keepdim=True)
    yn = torch.sum(y * y, dim=-1, keepdim=True)
    return xn + yn.T - 2.0 * torch.matmul(x, y.T), xn, yn


def hybrid_tail_bound(part, own_x, own_y, norm_x, norm_y, d: int):
    """Certified lower bound on the full squared distance for a model rank
    that owns one dimension group: ``part`` its exact partial, ``own_*``
    the group energies, ``norm_*`` the full squared norms. By the reverse
    triangle inequality over the dimensions it does not own,
    ``part + (√(‖x‖²−own_x) − √(‖y‖²−own_y))² ≤ ‖x − y‖²``, deflated by the
    PDX rounding guard so f32 round-off cannot lift it past the true
    distance; a rank may retire a lane on it alone."""
    from repro_torch.quant import pdx as pdx_mod

    ox = torch.clamp_min(norm_x - own_x, 0.0)
    oy = torch.clamp_min(norm_y - own_y, 0.0)
    rt = (torch.sqrt(ox) - torch.sqrt(oy)) ** 2
    return part + pdx_mod.deflate_tail(rt, norm_x + norm_y, d)


def _make_nlj_step(mesh: DeviceMesh, plan: MeshPlan, *, rows: int, d: int,
                   merge_cap: int, impl: str | None = None):
    """The per-wave step of the mesh exact NLJ: rows over the data axis
    and, for hybrid plans, whole-slab dimension groups over the model axis
    (``psum`` combine, certified per-rank retirement), then the MI
    driver's band-compact + ``all_gather`` pool merge. Vector plans take
    each shard's distances from #1 (``ops.pairwise_sq_dists``), the single
    device NLJ's kernel, so their pairs are its pairs. θ² is an argument
    of the step, so sweeps and served tenants reuse one step. Returns
    ``step(xw, Yb, th2, lane_valid) → (merged (S, B, merge_cap), n_keep
    (S, B))`` on the first shard's device; ``Yb`` the cached blocks."""
    S, k = plan.n_shards, plan.dim_shards
    daxis, maxis = plan.data_axis, plan.model_axis

    def device(s, g=0):
        if k == 1:
            return mesh.device_at(**{daxis: s})
        return mesh.device_at(**{daxis: s, maxis: g})

    def step(xw, Yb, th2, lane_valid):
        lv = torch.as_tensor(np.asarray(lane_valid))
        cands, keeps = [], []
        for s in range(S):
            dev = device(s)
            if k > 1:
                w = xw.shape[1] // k
                parts, own_x, own_y = [], [], []
                for g in range(k):
                    p, xn, yn = _group_partial(
                        _as_f32(xw[:, g * w:(g + 1) * w], device(s, g)),
                        Yb[s][g])
                    parts.append(p)
                    own_x.append(xn)
                    own_y.append(yn)
                # full norms, certified per-rank retirement, exact combine
                nx, ny = psum(own_x, dev), psum(own_y, dev)
                flags = []
                for g in range(k):
                    gd = device(s, g)
                    bound = hybrid_tail_bound(parts[g], own_x[g], own_y[g].T,
                                              nx.to(gd), ny.T.to(gd), d)
                    flags.append((bound > th2).to(torch.int32))
                retired = psum(flags, dev)
                d2 = psum(parts, dev)
                kept = (retired == 0) & (d2 < th2)
            else:
                y, yn = Yb[s]
                kept = ops.pairwise_sq_dists(_as_f32(xw, dev), y, yn=yn,
                                             impl=impl) < th2
            kept = kept & lv.to(dev)[:, None]
            ids = torch.arange(s * rows, (s + 1) * rows, dtype=torch.int32,
                               device=dev)
            gids = torch.where(kept, ids[None, :], NO_NODE)
            keeps.append(torch.sum(kept, dim=1, dtype=torch.int32))
            cands.append(ops.band_compact(kept, gids, merge_cap)[1])
        dst = device(0)
        return all_gather(cands, dst), all_gather(keeps, dst)

    return step


def distributed_nlj_join(X, Y, plan: MeshPlan, *, theta: float,
                         wave_size: int = 256,
                         merge_cap: int = DEFAULT_MERGE_CAP,
                         step_cache: dict | None = None,
                         mesh: DeviceMesh | None = None,
                         impl: str | None = None):
    """The mesh exact NLJ driver: the pair-producing path behind a
    ``MeshPlan``'s vector and hybrid plans.

    Y's rows are padded to ``n_shards`` even shards with far-away (1e3)
    sentinels and split over the data axis; for hybrid plans the
    dimensions are zero-padded to whole slabs and split over the model
    axis. ``mesh`` holds the plan's devices (``plan.make_mesh()``, the
    visible CUDA devices, when omitted). The kept pool is merged on the
    devices and fetched as one block a wave; merge overflow grows the
    sticky cap and re-runs the wave.

    ``step_cache`` (an engine-owned dict) keeps the step, the
    device-resident Y blocks and the sticky merge cap across calls (θ² is
    a runtime argument). Returns ``(pairs, stats)``."""
    from repro_torch.engine import waves as W
    from repro_torch.quant.pdx import DEFAULT_SLAB

    cache = step_cache if step_cache is not None else {}
    n_data, d = int(Y.shape[0]), int(Y.shape[1])
    S, k = plan.n_shards, plan.dim_shards
    mesh = plan.make_mesh(mesh)
    key = (plan, n_data, d, mesh.devices)
    if cache.get("key") != key:
        rows = -(-n_data // S)
        cache.clear()
        Yb = []
        for s in range(S):
            dev = (mesh.device_at(**{plan.data_axis: s}) if k == 1
                   else mesh.device_at(**{plan.data_axis: s,
                                          plan.model_axis: 0}))
            ys = _as_f32(Y[s * rows:min((s + 1) * rows, n_data)], dev)
            if ys.shape[0] < rows:
                ys = torch.cat([ys, torch.full((rows - ys.shape[0], d), 1e3,
                                               device=dev)])
            if k == 1:
                Yb.append((ys.contiguous(), sq_norms(ys)))
                continue
            ysp, w = _pad_cols(ys, k, DEFAULT_SLAB)
            Yb.append([_as_f32(ysp[:, g * w:(g + 1) * w],
                               mesh.device_at(**{plan.data_axis: s,
                                                 plan.model_axis: g}))
                       .contiguous() for g in range(k)])
        cache.update(key=key, rows=rows, Yb=Yb,
                     mcap=W.StickyCap(merge_cap, rows * S), steps={})
    rows = cache["rows"]
    mcap = cache["mcap"]

    def get_step():
        if mcap.cap not in cache["steps"]:
            cache["steps"][mcap.cap] = _make_nlj_step(
                mesh, plan, rows=rows, d=d, merge_cap=mcap.cap, impl=impl)
        return cache["steps"][mcap.cap]

    Xd = _as_f32(X, mesh.devices[0])
    Xp, _ = _pad_cols(Xd, k, DEFAULT_SLAB) if k > 1 else (Xd, d)
    th2 = traversal.sq_theta(theta)
    stats = JoinStats()
    pairs_out = []
    tr = obs_trace.tracer()

    def dispatch(xw, lane_valid):
        outs = get_step()(xw, cache["Yb"], th2, lane_valid)
        B = int(lane_valid.shape[0])
        # collective meters: the pool combine over the data axis and, for
        # hybrid plans, the psum'd partials, norms and retirement flags
        combine = (S - 1) * B * mcap.cap * 4
        if plan.pool_combine == "ppermute":
            stats.bytes_ppermute += S * combine
        else:
            stats.bytes_allgather += S * combine
        if k > 1:
            stats.bytes_psum += (plan.n_devices * (k - 1)
                                 * (2 * B * rows + B + rows) * 4)
        return outs

    nq = int(Xp.shape[0])
    for q0 in range(0, nq, wave_size):
        ids = np.arange(q0, min(q0 + wave_size, nq))
        padded, lane_valid = W.pad_wave(ids.astype(np.int32), wave_size)
        xw = Xp[torch.as_tensor(padded, device=Xp.device)]
        outs = dispatch(xw, lane_valid)
        while True:
            t0 = time.perf_counter()
            merged, n_keep = (o.cpu().numpy() for o in outs)
            stats.wait_seconds += time.perf_counter() - t0
            stats.bytes_assembly += merged.nbytes + n_keep.nbytes
            # against the fetched block's width (= the dispatch cap)
            if not (n_keep[:, lane_valid] > merged.shape[2]).any():
                break
            need = int(n_keep[:, lane_valid].max())
            if tr:
                tr.instant("wave/merge_retry", lane="traversal",
                           needed=need, merge_cap=mcap.cap)
            stats.overflow_retries += 1
            mcap.grow(need)
            outs = dispatch(xw, lane_valid)
        t1 = time.perf_counter()
        sh, ln, sl = np.nonzero(merged != NO_NODE)
        pairs_out.append(np.stack([padded[ln], merged[sh, ln, sl]], axis=1))
        # logical distance count: sentinel rows are not real comparisons
        stats.n_dist += int(lane_valid.sum()) * n_data
        stats.other_seconds += time.perf_counter() - t1
    pairs = (np.concatenate(pairs_out, axis=0) if pairs_out
             else np.empty((0, 2), np.int64)).astype(np.int64)
    pairs = pairs[pairs[:, 1] < n_data]      # sentinel belt-and-braces
    stats.band_occ_per_shard = (0,) * S      # the NLJ has no re-rank band
    return pairs, stats


# ---------------------------------------------------------------------------
# exact NLJ counts with 2-D (data × model) sharding
# ---------------------------------------------------------------------------

def make_distributed_nlj_count(mesh: DeviceMesh, data_axes, model_axis: str,
                               *, theta: float):
    """Exact per-query counts with Y's rows sharded over ``data_axes`` and
    the vector dimension over ``model_axis``
    (``repro.core.distributed.make_distributed_nlj_count``). Each (data,
    model) block computes its partial ``xn + ynᵀ − 2·x@yᵀ`` over its
    dimension slice (``_group_partial``, the reference's arithmetic), the
    partials are ``psum``'d over the model axis, compared with θ² (f32) and
    the counts summed over the data axes. Queries go in waves of
    NLJ_COUNT_WAVE so one block's partial stays small; the counts are the
    same.

    Returns ``count(X, Y) → (B,) int32`` on the first device of the mesh:
    ``X`` (B, d) replicated, ``Y`` (N, d), both split here: rows into
    ``ceil(N / S)`` a data shard (the last may hold fewer), dimensions
    into ``ceil(d / m)`` a model rank, zero-padded (a zero column adds 0
    to every partial)."""
    data_axes = ((data_axes,) if isinstance(data_axes, str)
                 else tuple(data_axes))
    S, m = mesh.axis_size(data_axes), mesh.axis_size(model_axis)
    sizes = [mesh.shape[mesh.axis_names.index(a)] for a in data_axes]
    th2 = float(np.float32(theta) ** 2)

    def device(s: int, g: int) -> torch.device:
        coords = dict(zip(data_axes, np.unravel_index(s, sizes)))
        return mesh.device_at(**coords, **{model_axis: g})

    def count(X, Y) -> torch.Tensor:
        X = torch.as_tensor(X, dtype=torch.float32)
        Y = torch.as_tensor(Y, dtype=torch.float32)
        B, (N, d) = X.shape[0], Y.shape
        rows, w = -(-N // S), -(-d // m)
        Xp = torch.nn.functional.pad(X, (0, w * m - d))
        Yp = torch.nn.functional.pad(Y, (0, w * m - d))
        dst = device(0, 0)
        out = torch.zeros((B,), dtype=torch.int32, device=dst)
        blocks = [[Yp[s * rows:(s + 1) * rows, g * w:(g + 1) * w]
                   .to(device(s, g)) for g in range(m)] for s in range(S)]
        for b0 in range(0, B, NLJ_COUNT_WAVE):
            xb = Xp[b0:b0 + NLJ_COUNT_WAVE]
            cnts = []
            for s in range(S):
                parts = [_group_partial(xb[:, g * w:(g + 1) * w]
                                        .to(device(s, g)), blocks[s][g])[0]
                         for g in range(m)]
                d2 = psum(parts, device(s, 0))
                cnts.append(torch.sum(d2 < th2, dim=1, dtype=torch.int32))
            out[b0:b0 + NLJ_COUNT_WAVE] = psum(cnts, dst)
        return out

    return count
