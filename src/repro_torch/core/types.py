"""Shared types for the vector-join core (PyTorch port of ``repro.core.types``).

Field names, defaults and validation follow the JAX package exactly, so a
config built for one package means the same join in the other. Tensors
live on an explicit ``torch.device``; the entry points resolve
``device=None`` to the CUDA card and refuse to run on the CPU unless the
caller names it (``resolve_device``).

Numerics: every f32 matrix product in the port is full IEEE f32.
``resolve_device`` turns TF32 off for cuBLAS and cuDNN, because TF32 moves
pairs that sit on the θ boundary and the reference computes true f32.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch

# Sentinel for "no neighbor" slots in padded neighbor tables.
NO_NODE = -1


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card.

    Raises when ``None`` is given and no CUDA device is visible, so nothing
    quietly runs on the CPU; tests pass ``device="cpu"`` explicitly. Also
    pins f32 matrix products to full IEEE f32 (TF32 off) and bf16 products
    to f32 sums throughout (no reduced-precision split-K reduction)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device visible: repro_torch runs on the card by "
                "default; pass device='cpu' to run the plain versions")
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class GraphIndex:
    """A graph-based ANN index in dense form (padded neighbor table).

    ``mean_nbr_dist`` is the paper's §4.5 side table (one f32 per node)
    used by the OOD predictor. Nodes with id < ``n_data`` are data points
    (Y); in a merged index G_{X∪Y}, ids in [n_data, N) are query nodes.
    """
    vecs: torch.Tensor            # (N, d) f32 node vectors
    nbrs: torch.Tensor            # (N, R) int32 neighbor ids, NO_NODE padded
    start: torch.Tensor           # () int32 navigating node (medoid)
    mean_nbr_dist: torch.Tensor   # (N,) f32 mean L2 distance to neighbors
    n_data: int

    @property
    def n_nodes(self) -> int:
        return self.vecs.shape[0]

    @property
    def degree(self) -> int:
        return self.nbrs.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vecs.device

    def is_data(self, ids: torch.Tensor) -> torch.Tensor:
        return (ids >= 0) & (ids < self.n_data)


def graph_index_from_numpy(vecs, nbrs, start, mean_nbr_dist, n_data: int,
                           device) -> GraphIndex:
    """Copy an index given as numpy arrays (for example one built by the
    reference package) onto ``device`` unchanged."""
    dev = torch.device(device)
    return GraphIndex(
        vecs=torch.tensor(np.asarray(vecs, np.float32), device=dev),
        nbrs=torch.tensor(np.asarray(nbrs, np.int32), device=dev),
        start=torch.tensor(int(np.asarray(start)), dtype=torch.int32,
                           device=dev),
        mean_nbr_dist=torch.tensor(np.asarray(mean_nbr_dist, np.float32),
                                   device=dev),
        n_data=int(n_data))


@dataclasses.dataclass(frozen=True)
class TraversalConfig:
    """Knobs for the batched traversal engine (paper Alg. 2 & 4).

    Same fields and defaults as ``repro.core.types.TraversalConfig``; see
    its docstring for each knob. ``dist_impl`` names the distance kernels'
    implementation (``kernels.ops``): ``None`` follows the tensors' device;
    ``cuda`` or ``ref`` must match it.
    """
    beam_width: int = 256
    expand_per_iter: int = 4
    patience: int = 10
    pool_cap: int = 1024
    hybrid_beam: int = 64
    hybrid_patience: int = 1
    hybrid_guard: float = 4.0
    seeds_max: int = 16
    max_iters: int = 4096
    rerank_cap: int = 128
    early_exit: bool = True
    dist_impl: str | None = None


def env_flag(name: str, default: bool) -> bool:
    """Boolean env-var override: unset or empty returns ``default``;
    anything else is true unless it spells ``0/off/false/no``."""
    env = os.environ.get(name)
    if env is not None and env.strip():
        return env.strip().lower() not in ("0", "off", "false", "no")
    return default


def early_exit_enabled(tcfg: TraversalConfig) -> bool:
    """``tcfg.early_exit``, unless the ``REPRO_EARLY_EXIT`` env var
    overrides it (``REPRO_EARLY_EXIT=off`` forces the full-scan PDX
    kernels everywhere)."""
    return env_flag("REPRO_EARLY_EXIT", tcfg.early_exit)


METHODS = ("nlj", "index", "es", "es_hws", "es_sws", "es_mi", "es_mi_adapt")
QUANT_MODES = ("off", "sq8", "sketch8", "pdx8", "sketchpdx8")

# Modes that route traversal through certified-lower-bound filtering.
QUANT_FILTER_MODES = ("sq8", "sketch8", "pdx8", "sketchpdx8")


@dataclasses.dataclass(frozen=True)
class JoinConfig:
    method: str = "es_mi_adapt"
    theta: float = 1.0
    traversal: TraversalConfig = dataclasses.field(default_factory=TraversalConfig)
    wave_size: int = 256           # queries processed per batched wave
    ood_factor: float = 1.5        # paper §4.5 d1 > 1.5 * d2
    quant: str = "off"             # compressed-storage mode (QUANT_MODES)
    # Two-stage wave pipeline (launch wave k+1 before assembling wave k);
    # pair sets are identical either way. REPRO_OVERLAP overrides it.
    overlap: bool = True

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"unknown method {self.method!r}; one of {METHODS}")
        if self.quant not in QUANT_MODES:
            raise ValueError(
                f"unknown quant mode {self.quant!r}; one of {QUANT_MODES}")


@dataclasses.dataclass
class JoinStats:
    """Per-join counters; the same fields as ``repro.core.types.JoinStats``
    (see there for each one), so the two packages report alike."""
    n_dist: int = 0
    n_iters: int = 0
    n_overflow: int = 0
    greedy_seconds: float = 0.0
    expand_seconds: float = 0.0
    other_seconds: float = 0.0
    n_ood: int = 0
    peak_cache_entries: int = 0
    n_rerank: int = 0
    quant_bytes: int = 0
    n_esc8: int = 0
    wait_seconds: float = 0.0
    n_rerank_gather: int = 0
    band_occ_per_shard: tuple = ()
    n_dims_scanned: int = 0
    n_dims_total: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    cache_evictions: int = 0
    cache_tombstones: int = 0
    bytes_feedback: int = 0
    bytes_band: int = 0
    bytes_assembly: int = 0
    # the mesh's collectives, as the reference's ranks move them (the port
    # combines every pool with all_gather; the plan's label picks the meter)
    bytes_allgather: int = 0
    bytes_ppermute: int = 0
    bytes_psum: int = 0
    overflow_retries: int = 0

    @property
    def total_seconds(self) -> float:
        return (self.greedy_seconds + self.expand_seconds
                + self.other_seconds + self.wait_seconds)

    @property
    def dims_scanned_frac(self) -> float:
        if self.n_dims_total <= 0:
            return 1.0
        return self.n_dims_scanned / self.n_dims_total

    def as_dict(self) -> dict[str, Any]:
        return dict(dataclasses.asdict(self), total_seconds=self.total_seconds,
                    dims_scanned_frac=self.dims_scanned_frac)

    # Non-additive fields; everything else merges by summation.
    _MERGE_MAX = ("peak_cache_entries",)
    _MERGE_CAT = ("band_occ_per_shard",)

    def merge(self, other: "JoinStats") -> "JoinStats":
        """Combine two disjoint pieces of work: counters and seconds sum,
        high-water marks take the max, per-shard tuples concatenate."""
        kw: dict[str, Any] = {}
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            if f.name in self._MERGE_MAX:
                kw[f.name] = max(a, b)
            elif f.name in self._MERGE_CAT:
                kw[f.name] = tuple(a) + tuple(b)
            else:
                kw[f.name] = a + b
        return JoinStats(**kw)

    def publish(self, metrics, prefix: str = "join") -> None:
        """Accumulate this join's stats into an ``obs.Metrics`` registry."""
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            name = f"{prefix}.{f.name}"
            if f.name in self._MERGE_MAX:
                metrics.gauge(name).set_max(v)
            elif f.name in self._MERGE_CAT:
                for i, b in enumerate(v):
                    metrics.gauge(f"{name}.shard{i}").set(int(b))
                if v:
                    mean = sum(v) / len(v)
                    metrics.gauge(f"{prefix}.shard_band_imbalance").set(
                        max(v) / mean if mean > 0 else 1.0)
            elif v:
                metrics.counter(name).inc(v)

    @classmethod
    def from_metrics(cls, metrics, prefix: str = "join") -> "JoinStats":
        """Materialize the registry's cumulative ``{prefix}.*`` values back
        into a ``JoinStats`` (the engine-lifetime aggregate)."""
        kw: dict[str, Any] = {}
        for f in dataclasses.fields(cls):
            name = f"{prefix}.{f.name}"
            if f.name in cls._MERGE_CAT:
                vals = []
                while metrics.get(f"{name}.shard{len(vals)}") is not None:
                    vals.append(int(metrics.value(f"{name}.shard{len(vals)}")))
                kw[f.name] = tuple(vals)
            else:
                v = metrics.value(name, 0)
                kw[f.name] = float(v) if f.type == "float" else int(v)
        return cls(**kw)


@dataclasses.dataclass
class JoinResult:
    """Join output: pairs[i] = (query_id, data_id)."""
    pairs: np.ndarray              # (P, 2) int64
    stats: JoinStats

    def pair_set(self) -> set[tuple[int, int]]:
        return set(map(tuple, self.pairs.tolist()))


def pair_keys(pairs: np.ndarray, n_data: int) -> np.ndarray:
    """Unique int64 keys ``q * n_data + y`` of a (P, 2) pair array."""
    p = np.asarray(pairs, np.int64).reshape(-1, 2)
    return np.unique(p[:, 0] * np.int64(n_data) + p[:, 1])


def recall(result: JoinResult, truth_pairs: np.ndarray) -> float:
    """Global recall vs ground-truth pair array (paper §2.1)."""
    truth_pairs = np.asarray(truth_pairs, np.int64).reshape(-1, 2)
    if len(truth_pairs) == 0:
        return 1.0
    span = int(max(truth_pairs[:, 1].max(initial=0),
                   np.asarray(result.pairs).reshape(-1, 2)[:, 1].max(
                       initial=0))) + 1
    found = pair_keys(result.pairs, span)
    truth = pair_keys(truth_pairs, span)
    return np.intersect1d(found, truth, assume_unique=True).size / truth.size
