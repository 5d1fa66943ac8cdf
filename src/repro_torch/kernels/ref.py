"""Plain PyTorch versions of the distance kernels (port of ``repro.kernels.ref``).

These are the semantic ground truth for the CUDA kernels in ``csrc/*.cu``
and the path ``kernels.ops`` takes for tensors on the CPU. The formulas are
the reference's: the matmul form clamped at 0 for pairwise distances (and
the NLJ count, which compares them with θ² in query blocks), the
difference form for per-query rows; the int8 versions dequantize first and
then take the f32 form, so they round differently from the kernels, which
stay in the integer domain per dimension group. The Hamming versions count
differing bits of sign-bit sketches held as int32 words (the reference's
uint32 bit patterns); the PDX versions accumulate slab by slab with the
reference's retirement latch (``_pdx_live_loop``), in the kernels' own
operation order. Two fused kernels have compositions as their plain
versions: the sketch tier's gather bounds (``gather_sketch_bounds``) and
the PDX band re-rank (``pdx_compact_gather_sq_dists``, over the band
compaction ``band_compact`` / ``band_scatter``).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def sq_theta(theta: float) -> float:
    """θ² rounded to f32, as the reference computes ``jnp.float32(θ) ** 2``."""
    return float(np.float32(theta) ** 2)


def sq_norms(a: torch.Tensor) -> torch.Tensor:
    """(n, d) → (n,) f32 squared row norms (the pairwise epilogue's inputs)."""
    a = a.float()
    return torch.sum(a * a, dim=-1)


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor,
                      xn: torch.Tensor | None = None,
                      yn: torch.Tensor | None = None) -> torch.Tensor:
    """(B, d) × (N, d) → (B, N) f32 ``max(‖x‖² + ‖y‖² − 2·x·yᵀ, 0)``;
    ``xn``/``yn`` are the squared norms (computed here when omitted)."""
    x = x.float()
    y = y.float()
    xn = (sq_norms(x) if xn is None else xn)[:, None]
    yn = (sq_norms(y) if yn is None else yn)[None, :]
    d = xn + yn - 2.0 * (x @ y.T)
    return torch.clamp_min(d, 0.0)


def pairlist_sq_dists(x: torch.Tensor, y: torch.Tensor, xn: torch.Tensor,
                      yn: torch.Tensor, qi: torch.Tensor,
                      yi: torch.Tensor) -> torch.Tensor:
    """(P,) f32 matmul-form distances of explicit pairs (x[qi], y[yi]),
    ``max(xn[qi] + yn[yi] − 2·x[qi]·y[yi], 0)``; a pair with an id out of
    range gives +inf."""
    ok = (qi >= 0) & (qi < x.shape[0]) & (yi >= 0) & (yi < y.shape[0])
    q = torch.where(ok, qi, 0).long()
    j = torch.where(ok, yi, 0).long()
    dot = torch.sum(x[q].float() * y[j].float(), dim=-1)
    d = torch.clamp_min(xn[q] + yn[j] - 2.0 * dot, 0.0)
    return torch.where(ok, d, torch.inf)


def nlj_count(x: torch.Tensor, y: torch.Tensor, theta: float, *,
              xn: torch.Tensor | None = None, yn: torch.Tensor | None = None,
              block_elems: int = 1 << 26) -> torch.Tensor:
    """(B,) int32 exact NLJ match count per query, |{n : d(x_b, y_n) < θ}|:
    ``pairwise_sq_dists`` (clamped at 0) against θ² squared in f32, over
    query blocks of at most ``block_elems`` distances, so a (B, N) matrix
    is never held whole."""
    x, y = x.float(), y.float()
    th2 = sq_theta(theta)
    xn = sq_norms(x) if xn is None else xn
    yn = sq_norms(y) if yn is None else yn
    out = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
    step = max(1, block_elems // max(y.shape[0], 1))
    for b0 in range(0, x.shape[0], step):
        d = pairwise_sq_dists(x[b0:b0 + step], y, xn[b0:b0 + step], yn)
        out[b0:b0 + step] = torch.sum(d < th2, dim=1, dtype=torch.int32)
    return out


def nlj_mask(x: torch.Tensor, y: torch.Tensor, theta: float) -> torch.Tensor:
    """(B, N) bool exact NLJ match matrix ``pairwise_sq_dists < θ²``."""
    return pairwise_sq_dists(x, y) < sq_theta(theta)


def rowwise_sq_dists(x: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """(B, d) × (B, K, d) → (B, K) f32 difference-form ``Σ (c − x)²``."""
    diff = cands.float() - x.float()[:, None, :]
    return torch.sum(diff * diff, dim=-1)


def gather_sq_dists(vecs: torch.Tensor, x: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    """(N, d) vecs × (B, d) x × (B, K) ids → (B, K) f32 squared distances
    ``rowwise_sq_dists(x, vecs[idx])``; ids outside [0, N) (NO_NODE) give
    +inf."""
    valid = (idx >= 0) & (idx < vecs.shape[0])
    safe = torch.where(valid, idx, 0).long()
    d = rowwise_sq_dists(x, vecs[safe])
    return torch.where(valid, d, torch.inf)


def gather_sq_dists_pairs(vecs: torch.Tensor, x: torch.Tensor,
                          qi: torch.Tensor, yi: torch.Tensor) -> torch.Tensor:
    """(P,) f32 ``gather_sq_dists(vecs, x[qi], yi[:, None])[:, 0]``: the
    difference-form distances of explicit pairs; an id or a query row out
    of range gives +inf."""
    if x.shape[0] == 0 or vecs.shape[0] == 0:
        return torch.full(qi.shape, torch.inf, device=x.device)
    ok = (qi >= 0) & (qi < x.shape[0])
    d = gather_sq_dists(vecs, x[torch.where(ok, qi, 0).long()], yi[:, None])
    return torch.where(ok, d[:, 0], torch.inf)


def topk_merge(beam_dist: torch.Tensor, beam_idx: torch.Tensor,
               cand_dist: torch.Tensor, cand_idx: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge a sorted (B, L) beam with (B, K) candidates; keep the L
    smallest, ascending. The sort is stable, so ties go to the beam and
    then to the lower candidate slot, as ``jnp.argsort`` orders them.
    Slots holding +inf come back with the id NO_NODE (-1), as the
    reference's Pallas kernel returns its empty slots."""
    L = beam_dist.shape[-1]
    alld = torch.cat([beam_dist, cand_dist], dim=-1)
    alli = torch.cat([beam_idx, cand_idx.to(beam_idx.dtype)], dim=-1)
    alld, order = torch.sort(alld, dim=-1, stable=True)
    alli = torch.gather(alli, -1, order)
    od, oi = alld[:, :L], alli[:, :L]
    return od, torch.where(od == torch.inf, -1, oi).to(beam_idx.dtype)


# ---------------------------------------------------------------------------
# int8 (QuantStore codes): dequantize, then the f32 forms
# ---------------------------------------------------------------------------

def _dequant(q: torch.Tensor, scales: torch.Tensor,
             group_size: int) -> torch.Tensor:
    from repro_torch.quant.store import dequantize
    return dequantize(q, scales, group_size)


def pairwise_sq_dists_int8(qx: torch.Tensor, qy: torch.Tensor,
                           scales: torch.Tensor, *,
                           group_size: int = 128) -> torch.Tensor:
    """Quantized-domain pairwise squared L2 ``‖x̂ − ŷ‖²`` via dequantize."""
    return pairwise_sq_dists(_dequant(qx, scales, group_size),
                             _dequant(qy, scales, group_size))


def pairwise_sq_dists_int8_exact(qx: torch.Tensor, qy: torch.Tensor,
                                 scales: torch.Tensor, xn: torch.Tensor,
                                 yn: torch.Tensor, *,
                                 group_size: int = 128) -> torch.Tensor:
    """The int8 pairwise kernel's own arithmetic, for bit-exact checks:
    each group's integer dot through a float64 product of the codes (exact:
    |dot| ≤ 128²·gs < 2⁵³), then the kernel's f32 steps in torch — ``sum +=
    s_g²·dot_g`` group by group from 0, then ``max(xn + yn − 2·sum, 0)``
    with the given (dequantized) squared norms."""
    d = qx.shape[1]
    x64, y64 = qx.double(), qy.double()
    total = torch.zeros((qx.shape[0], qy.shape[0]), dtype=torch.float32,
                        device=qx.device)
    for g in range(-(-d // group_size)):
        sl = slice(g * group_size, min((g + 1) * group_size, d))
        dot = (x64[:, sl] @ y64[:, sl].T).float()
        s = scales[g]
        total = total + (s * s) * dot
    return torch.clamp_min(xn[:, None] + yn[None, :] - 2.0 * total, 0.0)


def quant_lower_bound(d_hat: torch.Tensor, slack: torch.Tensor
                      ) -> torch.Tensor:
    """Certified lower bound on the true squared distance from the
    quantized-domain ``d_hat`` and the per-pair L2 slack
    ``‖x−x̂‖ + ‖y−ŷ‖`` (triangle inequality); +inf ``d_hat`` stays +inf."""
    lb = torch.clamp_min(torch.sqrt(torch.clamp_min(d_hat, 0.0)) - slack,
                         0.0)
    return torch.where(torch.isfinite(d_hat), lb * lb, d_hat)


def quant_upper_bound(d_hat: torch.Tensor, slack: torch.Tensor
                      ) -> torch.Tensor:
    """Certified upper bound on the true squared distance (symmetric)."""
    ub = torch.sqrt(torch.clamp_min(d_hat, 0.0)) + slack
    return torch.where(torch.isfinite(d_hat), ub * ub, d_hat)


def int8_bounds(dhat: torch.Tensor, xn: torch.Tensor, yn: torch.Tensor,
                xe: torch.Tensor, ye: torch.Tensor, guard: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 tier's certified (lb, ub) from a (B, N) matmul-form d̂:
    the f32 cancellation guard ``guard·(xn + yn)`` first, then the
    triangle-inequality slack ``xe + ye`` (``Int8Tier.pairwise_bounds``;
    the plain version of the fused bounds kernel)."""
    g = guard * (xn[:, None] + yn[None, :])
    slack = xe[:, None] + ye[None, :]
    return (quant_lower_bound(torch.clamp_min(dhat - g, 0.0), slack),
            quant_upper_bound(dhat + g, slack))


def rowwise_sq_dists_int8(qx: torch.Tensor, qcands: torch.Tensor,
                          scales: torch.Tensor, *,
                          group_size: int = 128) -> torch.Tensor:
    """Quantized-domain rowwise squared L2 over (B, K, d) candidates."""
    return rowwise_sq_dists(_dequant(qx, scales, group_size),
                            _dequant(qcands, scales, group_size))


def gather_sq_dists_int8(codes: torch.Tensor, qx: torch.Tensor,
                         idx: torch.Tensor, scales: torch.Tensor, *,
                         group_size: int = 128) -> torch.Tensor:
    """``rowwise_sq_dists_int8(qx, codes[idx])``; ids outside [0, N)
    (NO_NODE) give +inf."""
    valid = (idx >= 0) & (idx < codes.shape[0])
    safe = torch.where(valid, idx, 0).long()
    d = rowwise_sq_dists_int8(qx, codes[safe], scales, group_size=group_size)
    return torch.where(valid, d, torch.inf)


def gather_sq_dists_int8_exact(codes: torch.Tensor, qx: torch.Tensor,
                               idx: torch.Tensor, scales: torch.Tensor, *,
                               group_size: int = 128) -> torch.Tensor:
    """The int8 gather kernel's own arithmetic, for bit-exact checks: each
    group's sum of squared code differences exact in int64, then ``sum +=
    s_g²·sum_g`` in f32 group by group from 0; ids outside [0, N)
    (NO_NODE) give +inf."""
    if codes.shape[0] == 0:
        return torch.full(idx.shape, torch.inf, device=qx.device)
    valid = (idx >= 0) & (idx < codes.shape[0])
    diff = (codes[torch.where(valid, idx, 0).long()].long()
            - qx.long()[:, None, :])
    sq = diff * diff
    d = qx.shape[1]
    total = torch.zeros(idx.shape, dtype=torch.float32, device=qx.device)
    for g in range(-(-d // group_size)):
        s = scales[g]
        acc = sq[..., g * group_size:min((g + 1) * group_size, d)].sum(-1)
        total = total + (s * s) * acc.float()
    return torch.where(valid, total, torch.inf)


def gather_sq_dists_int8_pairs(codes: torch.Tensor, qx: torch.Tensor,
                               qi: torch.Tensor, yi: torch.Tensor,
                               scales: torch.Tensor, *,
                               group_size: int = 128) -> torch.Tensor:
    """(P,) ``gather_sq_dists_int8(codes, qx[qi], yi[:, None])[:, 0]``; an
    id or a query row out of range gives +inf (the d̂ of
    ``gather_bounds_int8_pairs``)."""
    if qx.shape[0] == 0 or codes.shape[0] == 0:
        return torch.full(qi.shape, torch.inf, device=qx.device)
    ok = (qi >= 0) & (qi < qx.shape[0])
    d = gather_sq_dists_int8(codes, qx[torch.where(ok, qi, 0).long()],
                             yi[:, None], scales, group_size=group_size)
    return torch.where(ok, d[:, 0], torch.inf)


def gather_bounds(d_hat: torch.Tensor, slack: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Certified (lb, ub) on the true squared distance from a
    difference-form ``d_hat`` (no cancellation guard) and the per-pair L2
    slack: the int8 tier's gather bounds, and the epilogue of the fused
    int8 gather bounds kernel."""
    return quant_lower_bound(d_hat, slack), quant_upper_bound(d_hat, slack)


def gather_bounds_int8(codes: torch.Tensor, qx: torch.Tensor,
                       idx: torch.Tensor, scales: torch.Tensor,
                       err: torch.Tensor, qerr: torch.Tensor, *,
                       group_size: int = 128
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the fused int8 gather bounds: (B, K) d̂ of
    ``gather_sq_dists_int8``, slack ``qerr[b] + err[id]``; NO_NODE gives
    +inf for both."""
    if codes.shape[0] == 0:
        inf = torch.full(idx.shape, torch.inf, device=qx.device)
        return inf, inf.clone()
    valid = (idx >= 0) & (idx < codes.shape[0])
    dhat = gather_sq_dists_int8(codes, qx, idx, scales, group_size=group_size)
    slack = qerr[:, None] + err[torch.where(valid, idx, 0).long()]
    return gather_bounds(dhat, slack)


def gather_bounds_int8_pairs(codes: torch.Tensor, qx: torch.Tensor,
                             qi: torch.Tensor, yi: torch.Tensor,
                             scales: torch.Tensor, err: torch.Tensor,
                             qerr: torch.Tensor, *, group_size: int = 128
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``gather_bounds_int8`` over explicit pairs: (P,) bounds of
    ``(qx[qi], codes[yi])`` with the slack ``qerr[qi] + err[yi]``."""
    if qx.shape[0] == 0 or codes.shape[0] == 0:
        inf = torch.full(qi.shape, torch.inf, device=qx.device)
        return inf, inf.clone()
    ok = (qi >= 0) & (qi < qx.shape[0]) & (yi >= 0) & (yi < codes.shape[0])
    q = torch.where(ok, qi, 0).long()
    y = torch.where(ok, yi, 0).long()
    dhat = gather_sq_dists_int8_pairs(codes, qx, qi, yi, scales,
                                      group_size=group_size)
    return gather_bounds(dhat, qerr[q] + err[y])


# ---------------------------------------------------------------------------
# 1-bit sketch codes: int32 words holding the reference's uint32 bits
# ---------------------------------------------------------------------------

def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Per-element bit count of int32 words (SWAR on the 32-bit pattern
    widened to int64, so every shift is logical)."""
    v = v.long() & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24 & 0xFF).to(torch.int32)


def pairwise_hamming(cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """(B, W) × (N, W) int32 sketch words → (B, N) int32 differing-bit
    counts."""
    pc = _popcount32(cx[:, None, :] ^ cy[None, :, :])
    return torch.sum(pc, dim=-1, dtype=torch.int32)


def rowwise_hamming(cx: torch.Tensor, ccands: torch.Tensor) -> torch.Tensor:
    """(B, W) × (B, K, W) int32 → (B, K) int32 counts over per-query
    candidate codes."""
    pc = _popcount32(ccands ^ cx[:, None, :])
    return torch.sum(pc, dim=-1, dtype=torch.int32)


def gather_hamming(codes: torch.Tensor, cx: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """``rowwise_hamming(cx, codes[idx])``; ids outside [0, N) (NO_NODE)
    give -1, which the sketch bound turns into +inf."""
    valid = (idx >= 0) & (idx < codes.shape[0])
    if codes.shape[0] == 0:
        return torch.full(idx.shape, -1, dtype=torch.int32, device=idx.device)
    safe = torch.where(valid, idx, 0).long()
    h = rowwise_hamming(cx, codes[safe])
    return torch.where(valid, h, -1).to(torch.int32)


def gather_sketch_bounds(codes, cx, idx, cum_q, cum_table, hs, iso, *,
                         dim: int, hamming=gather_hamming
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sketch tier's (B, K) gather bounds → ``(lb, est)``: the Hamming
    counts of ``hamming`` (this module's ``gather_hamming`` by default;
    given ``ops.gather_hamming``, the composition the fused kernel
    replaced, on the card), the certified lower bounds of
    ``quant.sketch.sketch_lower_bound_gather`` and the SimHash navigation
    estimate ``n_x + n_y − 2√(n_x n_y)·cos(πh/d)`` (not certified: callers
    only order pruned candidates by it). Ids outside [0, N) give +inf for
    both."""
    from repro_torch.quant.sketch import sketch_lower_bound_gather
    h = hamming(codes, cx, idx)
    lb, nc = sketch_lower_bound_gather(h, cum_q, cum_table, idx, hs, iso,
                                       dim=dim)
    nq = cum_q[:, -1][:, None]
    cos = torch.cos(math.pi * h.float() / dim)
    est = nq + nc - 2.0 * torch.sqrt(torch.clamp_min(nq * nc, 0.0)) * cos
    return lb, torch.where(torch.isfinite(lb), est, math.inf)


# ---------------------------------------------------------------------------
# PDX (dimension-partitioned) early-exit distances
# ---------------------------------------------------------------------------

def f32(v: float) -> float:
    """A python constant rounded to f32, as the kernels receive it."""
    return float(np.float32(v))


def _pdx_live_loop(slab_contribs, tails, th, nk: int, early_exit: bool):
    """Slab-ordered accumulation with the per-lane retirement latch.

    ``slab_contribs[k]`` is the f32 contribution of slab k, ``tails[k]``
    the deflated remaining-dims bound at the start of slab k, ``th`` the
    per-lane threshold. Returns ``(acc, nscan)``: retired lanes read +inf
    and the number of slabs they scanned; survivors hold the slab-ordered
    sum, the same additions in the same order as with ``early_exit`` off
    (so bit-identical to it)."""
    acc = torch.zeros_like(slab_contribs[0])
    if not early_exit:
        for k in range(nk):
            acc = acc + slab_contribs[k]
        return acc, torch.full(acc.shape, nk, dtype=torch.int32,
                               device=acc.device)
    scanned = torch.zeros(acc.shape, dtype=torch.int32, device=acc.device)
    for k in range(nk):
        live = (scanned == k) & (acc + tails[k] <= th)
        acc = torch.where(live, acc + slab_contribs[k], acc)
        scanned = torch.where(live, k + 1, scanned)
    return torch.where(scanned == nk, acc, torch.inf), scanned


def pairwise_sq_dists_pdx(qx, qy, scales, xslab, yslab, xtail, ytail, xn,
                          yn, xe, ye, theta: float, *, slab: int, dim: int,
                          early_exit: bool
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S·slab) × (N, S·slab) int8 PDX codes → ``(dhat, nscan)``: the
    slab-ordered quantized distance, slab k adding ``max(xslab_k + yslab_k
    − 2·s_k²·dot_k, 0)`` (``dot_k`` the int32 dot of the slab), +inf where
    a lane retired, and the slabs each lane scanned. A lane retires at
    slab k when its partial sum plus the deflated tail bound exceeds
    ``(θ + xe + ye)² + MATMUL_GUARD·(xn + yn)``."""
    from repro_torch.quant.cascade import MATMUL_GUARD
    from repro_torch.quant.pdx import deflate_tail
    nk = scales.shape[0]
    # int8 products summed in float64 are exact integers (the kernel's
    # int32 dot), on the CPU and on the card alike
    x64 = qx.double()
    y64 = qy.double()
    energy = xn[:, None] + yn[None, :]
    th = ((f32(theta) + xe[:, None] + ye[None, :]) ** 2
          + f32(MATMUL_GUARD) * energy)
    contribs, tails = [], []
    for k in range(nk):
        sl = slice(k * slab, (k + 1) * slab)
        dot = x64[:, sl] @ y64[:, sl].T
        s = scales[k]
        c = (xslab[:, k][:, None] + yslab[:, k][None, :]
             - 2.0 * (s * s) * dot.float())
        contribs.append(torch.clamp_min(c, 0.0))
        rt = (torch.sqrt(xtail[:, k])[:, None]
              - torch.sqrt(ytail[:, k])[None, :]) ** 2
        tails.append(deflate_tail(rt, energy, dim))
    return _pdx_live_loop(contribs, tails, th, nk, early_exit)


def pairwise_bounds_pdx(qx, qy, scales, xslab, yslab, xtail, ytail, xn, yn,
                        xe, ye, theta: float, *, slab: int, dim: int,
                        early_exit: bool
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The PDX tier's certified ``(lb, ub, nscan)``: ``int8_bounds`` over
    ``pairwise_sq_dists_pdx``'s ``dhat`` (the plain version of the fused
    PDX bounds kernel); a retired lane's +inf passes through both."""
    from repro_torch.quant.cascade import MATMUL_GUARD
    dhat, nscan = pairwise_sq_dists_pdx(
        qx, qy, scales, xslab, yslab, xtail, ytail, xn, yn, xe, ye, theta,
        slab=slab, dim=dim, early_exit=early_exit)
    lb, ub = int8_bounds(dhat, xn, yn, xe, ye, MATMUL_GUARD)
    return lb, ub, nscan


def pdx_gather_sq_dists(vp, vtail, vnorm, xp, xtail, xn, idx, th2: float,
                        *, dim: int, early_exit: bool
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, S·slab) f32 PDX rows read at (B, K) ids against (B, S·slab)
    PDX queries → ``(dist, nscan)``: the slab-ordered f32 difference-form
    sum, +inf where a lane retired against ``th2``; NO_NODE slots give
    (+inf, 0)."""
    from repro_torch.quant.pdx import deflate_tail
    valid = (idx >= 0) & (idx < vp.shape[0])
    if vp.shape[0] == 0:
        return (torch.full(idx.shape, torch.inf, device=idx.device),
                torch.zeros(idx.shape, dtype=torch.int32, device=idx.device))
    safe = torch.where(valid, idx, 0).long()
    nk = vtail.shape[1]
    slab = vp.shape[1] // max(nk, 1)
    vcand, vt = vp[safe], vtail[safe]
    energy = xn[:, None] + vnorm[safe]
    th = torch.full(energy.shape, f32(th2), device=energy.device)
    contribs, tails = [], []
    for k in range(nk):
        sl = slice(k * slab, (k + 1) * slab)
        diff = vcand[:, :, sl] - xp[:, None, sl]
        contribs.append(torch.sum(diff * diff, dim=-1))
        rt = (torch.sqrt(xtail[:, k])[:, None] - torch.sqrt(vt[:, :, k])) ** 2
        tails.append(deflate_tail(rt, energy, dim))
    d, ns = _pdx_live_loop(contribs, tails, th, nk, early_exit)
    return torch.where(valid, d, torch.inf), torch.where(valid, ns, 0)


# ---------------------------------------------------------------------------
# band compaction — sparse re-rank over a boolean band mask
# ---------------------------------------------------------------------------

def band_compact(mask: torch.Tensor, ids: torch.Tensor, cap: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stably compact the masked slots of a (B, C) id matrix into ``cap``
    slots. Returns ``(slots (B, cap) int32 source columns, −1 unused;
    cand (B, cap) int32 ids, NO_NODE unused; n_masked (B,) int32)``;
    entries ranked ≥ cap are not compacted — callers retry at a larger
    cap when ``n_masked > cap``."""
    B, C = mask.shape
    pos = torch.cumsum(mask, dim=1) - 1
    within = mask & (pos < cap)
    tgt = torch.where(within, pos, cap)
    col = torch.arange(C, dtype=torch.int32, device=mask.device).expand(B, C)
    slots = torch.full((B, cap + 1), -1, dtype=torch.int32,
                       device=mask.device)
    slots.scatter_(1, tgt, torch.where(within, col, -1))
    slots = slots[:, :cap]
    cand = torch.where(slots >= 0,
                       torch.gather(ids, 1, slots.clamp_min(0).long()),
                       -1).to(torch.int32)
    return slots, cand, torch.sum(mask, dim=1, dtype=torch.int32)


def band_scatter(slots: torch.Tensor, vals: torch.Tensor, C: int,
                 fill: float = float("inf")) -> torch.Tensor:
    """Inverse of ``band_compact``: (B, cap) compacted values back to
    their (B, C) source columns; unused slots read ``fill``."""
    B = slots.shape[0]
    tgt = torch.where(slots >= 0, slots, C).long()
    out = torch.full((B, C + 1), fill, dtype=vals.dtype, device=vals.device)
    out.scatter_(1, tgt, torch.where(slots >= 0, vals,
                                     torch.full_like(vals, fill)))
    return out[:, :C]


def pdx_compact_gather_sq_dists(vp, vtail, vnorm, xp, xtail, xn, ids, mask,
                                cap: int, th2: float, *, dim: int,
                                early_exit: bool, gather=pdx_gather_sq_dists):
    """The PDX band re-rank as a composition: ``band_compact`` of the
    masked slots into ``cap`` columns, the PDX gather over them
    (``gather``: this module's plain version by default; given
    ``ops.pdx_gather_sq_dists``, the composition the fused kernel
    replaced, on the card), ``band_scatter`` back, and the scan counters.
    Returns ``(exact, within, n_masked, n_scanned, n_total)``: ``exact``
    (B, C) +inf on retired and uncompacted slots; ``within`` the masked
    slots ranked below cap; ``n_masked`` (B,) int32; the dimensions
    scanned and those of a full scan over the compacted lanes with an id
    ≥ 0, 0-d int64."""
    C = ids.shape[1]
    slots, cand, n_masked = band_compact(mask, ids, cap)
    dist_c, nscan_c = gather(vp, vtail, vnorm, xp, xtail, xn, cand, th2,
                             dim=dim, early_exit=early_exit)
    exact = band_scatter(slots, dist_c, C)
    within = mask & (torch.cumsum(mask, dim=1) - 1 < cap)
    slab = vp.shape[1] // vtail.shape[1]
    valid = cand >= 0
    n_scanned = torch.sum(torch.where(
        valid, torch.clamp_max(nscan_c.long() * slab, dim), 0))
    n_total = torch.sum(valid) * dim
    return exact, within, n_masked, n_scanned, n_total


__all__ = ["sq_norms", "pairwise_sq_dists", "pairlist_sq_dists",
           "rowwise_sq_dists", "gather_sq_dists", "gather_sq_dists_pairs",
           "topk_merge",
           "pairwise_sq_dists_int8", "pairwise_sq_dists_int8_exact",
           "quant_lower_bound", "quant_upper_bound", "int8_bounds",
           "rowwise_sq_dists_int8",
           "gather_sq_dists_int8", "gather_sq_dists_int8_exact",
           "gather_sq_dists_int8_pairs",
           "gather_bounds", "gather_bounds_int8", "gather_bounds_int8_pairs",
           "pairwise_hamming", "rowwise_hamming",
           "gather_hamming", "gather_sketch_bounds", "pairwise_sq_dists_pdx",
           "pairwise_bounds_pdx", "pdx_gather_sq_dists", "band_compact",
           "band_scatter", "pdx_compact_gather_sq_dists"]
