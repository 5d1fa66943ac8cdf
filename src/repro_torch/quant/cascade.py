"""FilterCascade — the certified-bounds tier pipeline (port of
``repro.quant.cascade`` for the int8 tier).

A ``FilterCascade`` is an ordered chain of tiers over one vector table,
cheapest representation first; every tier brackets a candidate's squared
distance with certified bounds, and only the ambiguous band goes on to
the exact f32 re-rank. Threshold tests on lower bounds never reject a true
pair, tests on upper bounds never admit a false one. See the reference
module for the full design; the port keeps its interface:

  * ``encode(x)``       — queries on the tier's grid;
  * ``gather_bounds``   — (lb, ub) for the traversal's (B, K) candidate
    ids (the int8 gather kernel reads each code row by id);
  * ``pairwise_bounds`` — (lb, ub) against the whole store (NLJ shape);
  * ``pool_band``       — certified-sure vs ambiguous pool entries.

``TIERS_BY_MODE`` lists every quant mode of the reference. The 1-bit
sketch tier (``sketch1``, ROADMAP Queue A slice 8) and the PDX tier
(``pdx``, slice 9) are not ported yet: building them raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops
from repro_torch.quant.store import QuantStore, quantize_queries

# Relative f32 error of the matmul-form distance epilogue
# (xn + yn − 2·x·y), with an order of magnitude of headroom: the int8 NLJ
# filter and the cascade-driven build both guard by it (the reference's
# constant).
MATMUL_GUARD = 8 * 1.2e-7


def matmul_guard(xn: torch.Tensor, yn: torch.Tensor) -> torch.Tensor:
    """(B,) × (N,) norms → (B, N) absolute-error guard for matmul-form
    f32 distances between those rows."""
    return MATMUL_GUARD * (xn[:, None] + yn[None, :])


@dataclasses.dataclass(frozen=True)
class Int8Queries:
    """Queries quantized on an Int8Tier's scale grid."""
    q: torch.Tensor          # (B, d) int8 codes
    norms: torch.Tensor      # (B,) f32 dequantized squared norms
    err: torch.Tensor        # (B,) f32 exact per-query L2 error


@dataclasses.dataclass(frozen=True)
class Int8Tier:
    """The int8 confirming tier (QuantStore): certified lower *and* upper
    bounds — the tier that defines the re-rank band."""
    store: QuantStore

    name = "int8"
    build_counter = "quant"     # JoinEngine.build_counts key

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
        the table (NO_NODE) give +inf bounds and read no row."""
        st = self.store
        dhat = ops.gather_sq_dists_int8(st.q, qc.q, cand, st.scales,
                                        group_size=st.group_size, impl=impl)
        slack = qc.err[:, None] + st.err[cand.clamp_min(0).long()]
        return (ops.quant_lower_bound(dhat, slack),
                ops.quant_upper_bound(dhat, slack), None)

    def pairwise_bounds(self, qc: Int8Queries, *, impl: str | None,
                        y0: int = 0, y1: int | None = None):
        """(B, N) certified (lb, ub) against store rows [y0, y1) (all by
        default): the matmul-form epilogue's f32 cancellation is covered
        by ``matmul_guard`` before the triangle-inequality slack."""
        st = self.store
        y1 = st.n_vectors if y1 is None else y1
        yn = st.norms[y0:y1]
        dhat = ops.pairwise_sq_dists_int8(
            qc.q, st.q[y0:y1], st.scales, group_size=st.group_size,
            xn=qc.norms, yn=yn, impl=impl)
        slack = qc.err[:, None] + st.err[y0:y1][None, :]
        guard = matmul_guard(qc.norms, yn)
        lb = ops.quant_lower_bound(torch.clamp_min(dhat - guard, 0.0), slack)
        ub = ops.quant_upper_bound(dhat + guard, slack)
        return lb, ub

    def pool_band(self, qc: Int8Queries, pool_lb: torch.Tensor,
                  pool_idx: torch.Tensor, th2: float):
        """Split pooled lower-bound survivors into (sure, ambiguous)."""
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

_UNPORTED = {"sketch1": "the 1-bit sketch tier arrives with ROADMAP "
                        "Queue A slice 8 (sketch8)",
             "pdx": "the PDX tier arrives with ROADMAP Queue A slice 9 "
                    "(pdx8 / sketchpdx8)"}


def tier_class(name: str):
    if name == Int8Tier.name:
        return Int8Tier
    if name in _UNPORTED:
        raise NotImplementedError(_UNPORTED[name])
    raise ValueError(f"unknown tier {name!r}")


def build_tier_store(name: str, vecs, *, scale_rows=None, **kw):
    """Build the compressed store behind one tier (the offline step)."""
    if name == Int8Tier.name:
        from repro_torch.quant.store import build_store
        return build_store(vecs, scale_rows=scale_rows, **kw)
    tier_class(name)          # raises for the tiers still to port
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
