"""FilterCascade — the certified-bounds tier pipeline (port of
``repro.quant.cascade``).

A ``FilterCascade`` is an ordered chain of tiers over one vector table,
cheapest representation first; every tier brackets a candidate's squared
distance with certified bounds, and only the ambiguous band goes on to
the exact f32 re-rank. Threshold tests on lower bounds never reject a true
pair, tests on upper bounds never admit a false one. See the reference
module for the full design; the port keeps its interface:

  * ``encode(x)``       — queries on the tier's grid;
  * ``gather_bounds``   — (lb, ub, estimate) for the traversal's (B, K)
    candidate ids (the tier's gather kernel reads each code row by id;
    NO_NODE slots read no row and give +inf; each tier's kernel writes
    its certified bounds itself);
  * ``pairwise_bounds`` — (lb, ub) against the whole store (NLJ shape);
  * ``pair_refine``     — (lb, ub) for explicit (query, data) id pairs
    (the NLJ's escalation shape: the int8 tiers' pair-list entry reads
    each pair's query row in place; the sketch tier's gather kernel takes
    a (P, 1) id column);
  * ``pool_band``       — certified-sure vs ambiguous pool entries.

Three tiers: ``Int8Tier`` (int8 codes, lower and upper bounds),
``SketchTier`` (1-bit sign sketches, lower bounds only, plus a SimHash
navigation estimate for the candidates it prunes) and ``PdxTier``
(dimension-partitioned int8 codes with lower and upper bounds, whose NLJ
sweep and band re-rank retire lanes mid-vector). ``TIERS_BY_MODE`` maps
every quant mode of the reference to its chain.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops
from repro_torch.quant.pdx import PdxQueries, PdxStore, pdx_queries
from repro_torch.quant.sketch import (SketchStore, sketch_lower_bound_gather,
                                      sketch_lower_bound_pairwise,
                                      sketch_queries)
from repro_torch.quant.store import QuantStore, quantize_queries

# Relative f32 error of the matmul-form distance epilogue
# (xn + yn − 2·x·y), with an order of magnitude of headroom: the int8 NLJ
# filter and the cascade-driven build both guard by it (the reference's
# constant).
MATMUL_GUARD = 8 * 1.2e-7


@dataclasses.dataclass(frozen=True)
class Int8Queries:
    """Queries quantized on an Int8Tier's scale grid."""
    q: torch.Tensor          # (B, d) int8 codes
    norms: torch.Tensor      # (B,) f32 dequantized squared norms
    err: torch.Tensor        # (B,) f32 exact per-query L2 error


@dataclasses.dataclass(frozen=True)
class SketchQueries:
    """Queries encoded on a SketchTier's sketch grid."""
    codes: torch.Tensor      # (B, W) int32 packed sign bits
    cum: torch.Tensor        # (B, K) f32 exact slack tables


def _ids32(i: torch.Tensor) -> torch.Tensor:
    """A (P,) id vector as the (P, 1) int32 column the gather kernels take."""
    return i.to(torch.int32).reshape(-1, 1).contiguous()


def _refine_int8(codes, scales, group_size: int, err, qq, qerr, qi, yi):
    """Certified (lb, ub) of explicit (query, data) id pairs on one int8
    grid: the difference form (exact in int32 per group) with the pairs'
    L2 slack, by the int8 gather kernel's pair-list bounds entry, which
    reads each pair's query row in place."""
    return ops.gather_bounds_int8_pairs(
        codes, qq, qi.to(torch.int32), yi.to(torch.int32), scales, err=err,
        qerr=qerr, group_size=group_size)


@dataclasses.dataclass(frozen=True)
class Int8Tier:
    """The int8 confirming tier (QuantStore): certified lower *and* upper
    bounds — the tier that defines the re-rank band."""
    store: QuantStore

    name = "int8"
    build_counter = "quant"     # JoinEngine.build_counts key
    has_upper = True

    @property
    def nbytes(self) -> int:
        return self.store.nbytes

    def encode(self, x: torch.Tensor) -> Int8Queries:
        q, norms, err = quantize_queries(x, self.store)
        return Int8Queries(q=q, norms=norms, err=err)

    def rows_as_queries(self, i0: int, i1: int) -> Int8Queries:
        """Store rows themselves as queries (the offline build's
        self-join shape: no re-encoding)."""
        st = self.store
        return Int8Queries(q=st.q[i0:i1], norms=st.norms[i0:i1],
                           err=st.err[i0:i1])

    def gather_bounds(self, qc: Int8Queries, cand: torch.Tensor, *,
                      impl: str | None):
        """(B, K) candidate ids → certified (lb, ub, None); ids outside
        the table (NO_NODE) give +inf bounds and read no row. On the card
        one kernel computes d̂ and both bounds
        (``ops.gather_bounds_int8``)."""
        st = self.store
        lb, ub = ops.gather_bounds_int8(st.q, qc.q, cand, st.scales,
                                        err=st.err, qerr=qc.err,
                                        group_size=st.group_size, impl=impl)
        return lb, ub, None

    def pairwise_bounds(self, qc: Int8Queries, *, impl: str | None,
                        y0: int = 0, y1: int | None = None):
        """(B, N) certified (lb, ub) against store rows [y0, y1) (all by
        default): the matmul-form epilogue's f32 cancellation is covered
        by ``MATMUL_GUARD``·(xn + yn) before the triangle-inequality
        slack. On the card one kernel computes d̂ and both bounds
        (``ops.pairwise_bounds_int8``), bit for bit the composition the
        CPU runs (``kernels.ref.int8_bounds`` over d̂)."""
        st = self.store
        y1 = st.n_vectors if y1 is None else y1
        return ops.pairwise_bounds_int8(
            qc.q, st.q[y0:y1], st.scales, group_size=st.group_size,
            xn=qc.norms, yn=st.norms[y0:y1], xe=qc.err, ye=st.err[y0:y1],
            guard=MATMUL_GUARD, impl=impl)

    def pair_refine(self, qc: Int8Queries, qi: torch.Tensor,
                    yi: torch.Tensor):
        """Certified (lb, ub) for explicit (query, data) id pairs — the
        NLJ escalation shape."""
        st = self.store
        return _refine_int8(st.q, st.scales, st.group_size, st.err, qc.q,
                            qc.err, qi, yi)

    def pool_band(self, qc: Int8Queries, pool_lb: torch.Tensor,
                  pool_idx: torch.Tensor, th2: float):
        """Split pooled lower-bound survivors into (sure, ambiguous)."""
        s = qc.err[:, None] + self.store.err[pool_idx.clamp_min(0).long()]
        return ops.quant_band_from_lb(pool_lb, s, th2)


@dataclasses.dataclass(frozen=True)
class SketchTier:
    """The 1-bit pruning tier (SketchStore): certified lower bounds only
    (a sign sketch cannot upper-bound), plus a SimHash navigation
    estimate for the candidates it prunes."""
    store: SketchStore

    name = "sketch1"
    build_counter = "sketch"
    has_upper = False

    @property
    def nbytes(self) -> int:
        return self.store.nbytes

    def encode(self, x: torch.Tensor) -> SketchQueries:
        codes, cum = sketch_queries(x, self.store)
        return SketchQueries(codes=codes, cum=cum)

    def gather_bounds(self, qc: SketchQueries, cand: torch.Tensor, *,
                      impl: str | None):
        """(B, K) candidate ids → (lb, None, estimate): each code row and
        its two slack entries read by id (d/8 + 8 bytes a candidate), on
        the card in one kernel (``ops.gather_sketch_bounds``). The
        estimate ``n_x + n_y − 2√(n_x n_y)·cos(πh/d)`` is not certified:
        callers only order pruned candidates by it, never test a
        threshold."""
        st = self.store
        lb, est = ops.gather_sketch_bounds(st.codes, qc.codes, cand, qc.cum,
                                           st.cum, st.hs, st.iso, dim=st.dim,
                                           impl=impl)
        return lb, None, est

    def pairwise_bounds(self, qc: SketchQueries, *, impl: str | None,
                        y0: int = 0, y1: int | None = None):
        """(B, N) certified lower bounds against store rows [y0, y1)."""
        st = self.store
        y1 = st.n_vectors if y1 is None else y1
        h = ops.pairwise_hamming(qc.codes, st.codes[y0:y1], impl=impl)
        lb = sketch_lower_bound_pairwise(h, qc.cum, st.cum[y0:y1], st.hs,
                                         st.iso, dim=st.dim)
        return lb, None

    def pair_refine(self, qc: SketchQueries, qi: torch.Tensor,
                    yi: torch.Tensor):
        st = self.store
        qi, yi = qi.long(), yi.long()
        ids = _ids32(yi)
        h = ops.gather_hamming(st.codes, qc.codes[qi].contiguous(), ids)
        lb, _ = sketch_lower_bound_gather(h, qc.cum[qi], st.cum, ids, st.hs,
                                          st.iso, dim=st.dim)
        return lb[:, 0], None

    def pool_band(self, qc: SketchQueries, pool_lb: torch.Tensor,
                  pool_idx: torch.Tensor, th2: float):
        """No upper bounds: nothing is certified-sure, the whole pool is
        the band."""
        sure = torch.zeros(pool_lb.shape, dtype=torch.bool,
                           device=pool_lb.device)
        return sure, ~sure


@dataclasses.dataclass(frozen=True)
class PdxTier:
    """The dimension-partitioned confirming tier (PdxStore): certified
    lower and upper bounds like ``Int8Tier``, plus mid-vector early exit
    in its NLJ sweep (``pairwise_bounds_ee``) and in the wave pipeline's
    band re-rank (``ops.pdx_compact_gather_sq_dists``). Navigation and
    escalation never exit early: they order by the full bound."""
    store: PdxStore

    name = "pdx"
    build_counter = "pdx"       # JoinEngine.build_counts key
    has_upper = True
    early_exitable = True       # consumers may call pairwise_bounds_ee

    @property
    def nbytes(self) -> int:
        return self.store.nbytes

    def encode(self, x: torch.Tensor) -> PdxQueries:
        return pdx_queries(x, self.store)

    def rows_as_queries(self, i0: int, i1: int) -> PdxQueries:
        st = self.store
        return PdxQueries(vp=st.vp[i0:i1], ftail=st.ftail[i0:i1],
                          q=st.q[i0:i1], qslab=st.qslab[i0:i1],
                          qtail=st.qtail[i0:i1], norms=st.norms[i0:i1],
                          err=st.err[i0:i1])

    def gather_bounds(self, qc: PdxQueries, cand: torch.Tensor, *,
                      impl: str | None):
        """(B, K) candidate ids → certified (lb, ub, None): the full-scan
        difference form on the per-slab grid by the int8 gather bounds
        kernel, a slab as its dimension group."""
        st = self.store
        lb, ub = ops.gather_bounds_int8(st.q, qc.q, cand, st.scales,
                                        err=st.err, qerr=qc.err,
                                        group_size=st.slab, impl=impl)
        return lb, ub, None

    def _pairwise(self, qc: PdxQueries, theta: float, early_exit: bool,
                  impl: str | None, y0: int = 0, y1: int | None = None):
        st = self.store
        y1 = st.n_vectors if y1 is None else y1
        yn = st.norms[y0:y1]
        ye = st.err[y0:y1]
        # one kernel on the card: d̂ and its certified bounds (+inf d̂, a
        # retired lane, stays +inf through both: its certified lower bound
        # already exceeds the threshold)
        return ops.pairwise_bounds_pdx(
            qc.q, st.q[y0:y1], st.scales, qc.qslab, st.qslab[y0:y1],
            qc.qtail, st.qtail[y0:y1], qc.norms, yn, qc.err, ye, theta,
            slab=st.slab, dim=st.dim, early_exit=early_exit, impl=impl)

    def pairwise_bounds(self, qc: PdxQueries, *, impl: str | None,
                        y0: int = 0, y1: int | None = None):
        """(B, N) certified (lb, ub), full scan."""
        lb, ub, _ = self._pairwise(qc, 0.0, False, impl, y0, y1)
        return lb, ub

    def pairwise_bounds_ee(self, qc: PdxQueries, *, theta: float,
                           early_exit: bool, impl: str | None,
                           y0: int = 0, y1: int | None = None):
        """(B, N) certified (lb, ub, nscan) with mid-vector early exit
        against the L2 threshold ``theta``; retirement implies lb > θ², so
        the NLJ's band split is identical on and off."""
        return self._pairwise(qc, theta, early_exit, impl, y0, y1)

    def pair_refine(self, qc: PdxQueries, qi: torch.Tensor,
                    yi: torch.Tensor):
        """Difference-form certified (lb, ub) of explicit id pairs on the
        per-slab grid (padded dims are code 0 on both sides)."""
        st = self.store
        return _refine_int8(st.q, st.scales, st.slab, st.err, qc.q, qc.err,
                            qi, yi)

    def pool_band(self, qc: PdxQueries, pool_lb: torch.Tensor,
                  pool_idx: torch.Tensor, th2: float):
        s = qc.err[:, None] + self.store.err[pool_idx.clamp_min(0).long()]
        return ops.quant_band_from_lb(pool_lb, s, th2)


@dataclasses.dataclass(frozen=True)
class FilterCascade:
    """Ordered tier chain, cheapest first; the last tier confirms."""
    tiers: tuple

    @property
    def final(self):
        return self.tiers[-1]

    @property
    def names(self) -> tuple:
        return tuple(t.name for t in self.tiers)

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in self.tiers)

    def encode(self, x: torch.Tensor) -> tuple:
        """Queries encoded on every tier's grid, aligned with ``tiers``."""
        return tuple(t.encode(x) for t in self.tiers)

    def pool_band(self, qc: tuple, pool_lb, pool_idx, th2):
        """Certified-sure vs ambiguous split by the confirming tier."""
        return self.final.pool_band(qc[-1], pool_lb, pool_idx, th2)

    def tier(self, name: str):
        for t in self.tiers:
            if t.name == name:
                return t
        return None


# mode string (core.types.QUANT_MODES) → ordered tier names
TIERS_BY_MODE: dict[str, tuple] = {
    "off": (),
    "sq8": ("int8",),
    "sketch8": ("sketch1", "int8"),
    "pdx8": ("pdx",),
    "sketchpdx8": ("sketch1", "pdx"),
}

_TIER_CLASSES = {Int8Tier.name: Int8Tier, SketchTier.name: SketchTier,
                 PdxTier.name: PdxTier}


def tier_class(name: str):
    if name not in _TIER_CLASSES:
        raise ValueError(f"unknown tier {name!r}; one of "
                         f"{sorted(_TIER_CLASSES)}")
    return _TIER_CLASSES[name]


def build_tier_store(name: str, vecs, *, scale_rows=None, **kw):
    """Build the compressed store behind one tier (the offline step)."""
    if name == Int8Tier.name:
        from repro_torch.quant.store import build_store
        return build_store(vecs, scale_rows=scale_rows, **kw)
    if name == SketchTier.name:
        from repro_torch.quant.sketch import build_sketch
        return build_sketch(vecs, scale_rows=scale_rows, **kw)
    if name == PdxTier.name:
        from repro_torch.quant.pdx import build_pdx
        return build_pdx(vecs, scale_rows=scale_rows, **kw)
    tier_class(name)          # raises for an unknown name
    raise AssertionError(name)


def make_cascade(named_stores) -> FilterCascade | None:
    """Assemble a cascade from (tier_name, store) pairs (ordered)."""
    tiers = tuple(tier_class(n)(store) for n, store in named_stores)
    return FilterCascade(tiers=tiers) if tiers else None


def build_cascade(vecs, mode: str, *, scale_rows=None
                  ) -> FilterCascade | None:
    """Build every store a quant mode needs over one vector table."""
    names = TIERS_BY_MODE[mode]
    return make_cascade(
        [(n, build_tier_store(n, vecs, scale_rows=scale_rows))
         for n in names])
