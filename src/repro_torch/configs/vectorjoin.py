"""Vector-join operator configs (port of ``repro.configs.vectorjoin``).

``PRESETS`` name the paper's §5.1.2 methods; ``EngineSpec`` is how a
deployment instantiates ``JoinEngine`` (``n_shards=0``, the serving
presets': one shard per visible CUDA device). ``quant`` sets the storage
tiers every
join the engine serves filters through (``sq8``: certified int8 bounds;
``sketch8``: a 1-bit sketch prune above int8; ``pdx8``: the PDX tier with
mid-vector early exit; ``sketchpdx8``: the sketch above PDX), each with
an exact f32 re-rank of the ambiguous band; ``quant_build`` drives the
offline index builds through the int8 tier (identical edges, f32 build
traffic cut to the band; a mode without an int8 tier builds in f32).
``JOIN_DRYRUN_CELLS`` are the distributed-join dry-run cells beside the
LM's (X replicated on every shard, Y sharded over the data axes).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.types import JoinConfig

# paper §5.1.2 method presets (ES patience 10, L=256 defaults of [38])
PRESETS = {
    "nlj": JoinConfig(method="nlj"),
    "index": JoinConfig(method="index"),
    "es": JoinConfig(method="es"),
    "es_hws": JoinConfig(method="es_hws"),          # == SIMJOIN
    "es_sws": JoinConfig(method="es_sws"),
    "es_mi": JoinConfig(method="es_mi"),
    "es_mi_adapt": JoinConfig(method="es_mi_adapt"),
}


def preset(name: str, *, theta: float, **tcfg_kw) -> JoinConfig:
    cfg = PRESETS[name]
    tr = dataclasses.replace(cfg.traversal, **tcfg_kw) if tcfg_kw \
        else cfg.traversal
    return dataclasses.replace(cfg, theta=theta, traversal=tr)


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Constructor recipe for a ``repro_torch.engine.JoinEngine``."""
    k: int = 48                    # kNN candidates per node at build time
    degree: int = 32               # index max out-degree R
    style: str = "nsg"
    n_shards: int = 1              # 0 = one shard per visible device
    carry_window: int = 4096       # streaming work-sharing donor window
    max_cached_indexes: int = 4    # per-X artifact LRU capacity
    quant: str = "off"             # storage mode of the joins (QUANT_MODES)
    quant_build: str = "off"       # cascade-driven index builds

    def build_kw(self) -> dict:
        kw = dict(k=self.k, degree=self.degree, style=self.style)
        if self.quant_build != "off":
            kw["quant"] = self.quant_build
        return kw


ENGINE_PRESETS = {
    # single-device defaults matching the paper's offline build
    "default": EngineSpec(),
    # CI-scale: smaller graphs, fast builds
    "ci": EngineSpec(k=32, degree=24),
    # serving: the data side sharded over every visible device
    "serving": EngineSpec(n_shards=0, carry_window=16_384,
                          max_cached_indexes=8),
    # serving on int8 codes with the exact re-rank; the offline builds
    # through the same tier (identical edges)
    "serving_sq8": EngineSpec(n_shards=0, carry_window=16_384,
                              max_cached_indexes=8, quant="sq8",
                              quant_build="sq8"),
    # 1-bit sketch prune → int8 confirm → f32 re-rank, the offline build
    # through the int8 tier
    "serving_sketch8": EngineSpec(n_shards=0, carry_window=16_384,
                                  max_cached_indexes=8, quant="sketch8",
                                  quant_build="sq8"),
}


def make_engine(Y, spec: str | EngineSpec = "default", *,
                default: JoinConfig | None = None, device=None, mesh=None,
                **overrides):
    """Instantiate a ``JoinEngine`` from a named (or explicit) spec;
    ``device=None`` means the CUDA card (``mesh``, a ``DeviceMesh``, puts
    the shards on its devices). A spec with ``quant`` other than ``off``
    sets that mode on the engine's default ``JoinConfig``."""
    from repro_torch.engine import JoinEngine

    if isinstance(spec, str):
        spec = ENGINE_PRESETS[spec]
    if overrides:
        spec = dataclasses.replace(spec, **overrides)
    if spec.quant != "off":
        default = dataclasses.replace(default or JoinConfig(),
                                      quant=spec.quant)
    return JoinEngine(Y, build_kw=spec.build_kw(), default=default,
                      n_shards=spec.n_shards, mesh=mesh,
                      carry_window=spec.carry_window,
                      max_cached_indexes=spec.max_cached_indexes,
                      device=device)


@dataclasses.dataclass(frozen=True)
class JoinCell:
    """One distributed-join dry-run cell (``launch.dryrun.run_join_cell``).

    max_iters bounds the traversal loop; for the roofline it is set to the
    *expected* per-wave iteration count (the production safety bound of
    4096 would make the static cost model 100× pessimistic — measured CI
    waves converge in ≲64 iterations). dtype bf16 halves the gather
    traffic of the distance hot-spot (the f32 sums stay: #3's bf16 entry).
    """
    name: str
    n_query: int
    n_data: int          # global |Y| (sharded over data axes)
    dim: int
    degree: int          # index max out-degree R
    wave_size: int
    pool_cap: int
    hybrid: bool = False
    max_iters: int = 64
    dtype: str = "float32"
    # the traversal loop exits data-dependently, so one iteration is
    # traced; the dry run scales it by this measured expectation (es_mi on
    # CI data: ~3 iters/wave at θ1, ~52 at θ4)
    expected_iters: int = 32


JOIN_DRYRUN_CELLS = (
    # embedding-scale joins: |Y| per shard × 256/512 shards ⇒ 0.1–1B rows
    JoinCell("join_sift_like", 10_000, 524_288, 128, 32, 256, 512),
    JoinCell("join_clip_like", 10_000, 524_288, 512, 32, 256, 512),
    JoinCell("join_ood_hybrid", 10_000, 262_144, 512, 32, 256, 512,
             hybrid=True),
    JoinCell("join_lm_embed", 4_096, 1_048_576, 2048, 32, 256, 256),
    # bf16 vectors (distances still f32-accumulated)
    JoinCell("join_lm_embed_bf16", 4_096, 1_048_576, 2048, 32, 256, 256,
             dtype="bfloat16"),
)
