"""SketchStore — 1-bit binary sketches with certified L2 lower bounds (port
of ``repro.quant.sketch``).

Each vector is reduced to the sign bits of its rotated, centered
coordinates ``z = R (v − μ)``, packed 32 to a word, plus an exact per-row
slack table that turns Hamming distances between codes into certified
lower bounds on true squared L2 distances:

  * ``codes`` — (N, W) int32 words, W = ⌈d/32⌉; bit i of a row is
    ``z_i > 0``, little-endian within each word. The words hold the same
    bit patterns as the reference's uint32 codes (compare with
    ``.view(np.uint32)``); the Hamming kernels only XOR and count bits, so
    the sign of a word never matters;
  * ``cum``   — (N, K) exact sums of the ``hs[k]`` smallest squared
    rotated coordinates (``cum[:, -1] = ‖z‖²``);
  * ``iso``   — the certified isometry factor of the actual f32 rotation.

With ``h`` the Hamming distance of two codes, ``‖zx − zy‖² ≥ max(lb₁,
lb₂)`` where ``lb₁ = cum_x(h) + cum_y(h)`` (coordinates of differing sign)
and ``lb₂ = n_x + n_y − 2√((n_x − cum_x(h))(n_y − cum_y(h)))``
(Cauchy–Schwarz over the agreeing ones); ``_lb_from_cum`` scales by
``iso`` and subtracts a rounding guard. See the reference module for the
derivation. The rotation and the checkpoint grid are the reference's
numpy code, so both packages build the same ``R``, ``iso`` and ``hs``;
the encoding's f32 matrix product and prefix sums may round differently
from XLA's in the last bit (a sign bit at z ≈ 0 can flip), and each
store's bounds are certified on its own terms either way.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.quant.store import arrays_nbytes

WORD_BITS = 32
DEFAULT_N_CHECKPOINTS = 16

# certification guards for f32 arithmetic (the reference's constants)
_ISO_SLACK = 1e-4
_GUARD = 1e-4
_GUARD_PER_DIM = 4 * 1.2e-7


@dataclasses.dataclass(frozen=True)
class SketchStore:
    """1-bit companion of a vector table (or ``GraphIndex.vecs``)."""
    codes: torch.Tensor      # (N, W) int32 packed sign bits, W = ⌈d/32⌉
    cum: torch.Tensor        # (N, K) f32 exact order-statistics slack table
    hs: torch.Tensor         # (K,) int32 checkpoint Hamming values (0 … d)
    mu: torch.Tensor         # (d,) f32 center
    rot: torch.Tensor        # (d, d) f32 rotation R (z = R (v − μ))
    iso: torch.Tensor        # () f32 certified isometry factor (≤ 1)

    @property
    def n_vectors(self) -> int:
        return self.codes.shape[0]

    @property
    def dim(self) -> int:
        return self.mu.shape[0]

    @property
    def n_words(self) -> int:
        return self.codes.shape[1]

    @property
    def n_checkpoints(self) -> int:
        return self.hs.shape[0]

    @property
    def nbytes(self) -> int:
        return arrays_nbytes(self.codes, self.cum, self.hs, self.mu,
                             self.rot, self.iso)


def checkpoint_grid(d: int, n_checkpoints: int = DEFAULT_N_CHECKPOINTS
                    ) -> np.ndarray:
    """Monotone Hamming checkpoints ``0 = hs[0] < … ≤ hs[-1] = d``."""
    ks = (np.arange(n_checkpoints) * d) // n_checkpoints
    return np.unique(np.concatenate([ks, [d]])).astype(np.int32)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, d) bool → (N, ⌈d/32⌉) int32 words, little-endian within each
    word; padding bits are 0 for every row, so they never differ."""
    n, d = bits.shape
    W = -(-max(d, 1) // WORD_BITS)
    pad = W * WORD_BITS - d
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    w = bits.reshape(n, W, WORD_BITS).long()
    shift = torch.arange(WORD_BITS, device=bits.device)
    v = torch.sum(w << shift, dim=-1)                  # < 2**32
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def sketch_encode(x: torch.Tensor, mu: torch.Tensor, rot: torch.Tensor,
                  hs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode rows on an existing sketch grid → ``(codes, cum)``: the one
    code scheme of stores and queries alike."""
    x = x.float()
    z = (x - mu) @ rot.T
    codes = _pack_bits(z > 0)
    s = torch.sort(z * z, dim=1)[0]
    cumfull = torch.cat([torch.zeros((x.shape[0], 1), device=x.device),
                         torch.cumsum(s, dim=1)], dim=1)
    return codes, cumfull[:, hs.long()].contiguous()


@functools.lru_cache(maxsize=8)
def make_rotation(d: int, seed: int = 0) -> tuple[np.ndarray, np.float32]:
    """Seeded random rotation + its certified isometry factor (the
    reference's numpy QR and float64 SVD, so the same matrix). Treat the
    returned array as read-only: it is memoized."""
    rng = np.random.default_rng(seed)
    R = np.linalg.qr(rng.normal(size=(d, d)))[0].astype(np.float32)
    sigma_max = float(np.linalg.svd(R.astype(np.float64),
                                    compute_uv=False).max())
    return R, np.float32((1.0 - _ISO_SLACK) / sigma_max ** 2)


def build_sketch(vecs, *, n_checkpoints: int = DEFAULT_N_CHECKPOINTS,
                 seed: int = 0, scale_rows=None, device=None,
                 rotation: tuple[np.ndarray, np.float32] | None = None
                 ) -> SketchStore:
    """Sketch a vector table once (index-build time).

    ``vecs`` is a tensor (kept on its device) or an array (placed on
    ``device``, the card when ``None``). ``scale_rows`` masks which rows
    set the center ``μ``; every row is encoded."""
    from repro_torch.core.types import resolve_device
    if isinstance(vecs, torch.Tensor):
        v = vecs.float()
    else:
        v = torch.as_tensor(np.asarray(vecs, np.float32),
                            device=resolve_device(device))
    dev = v.device
    d = v.shape[1]
    R, iso = rotation if rotation is not None else make_rotation(d, seed)
    src = v
    if scale_rows is not None:
        sr = torch.as_tensor(np.asarray(scale_rows, bool), device=dev)
        if bool(sr.any()):
            src = v[sr]
    # the reference's numpy mean (its pairwise f32 summation), on the host
    mu = torch.as_tensor(src.cpu().numpy().mean(axis=0).astype(np.float32),
                         device=dev)
    hs = torch.as_tensor(checkpoint_grid(d, n_checkpoints), device=dev)
    rot = torch.as_tensor(R, device=dev)
    codes, cum = sketch_encode(v, mu, rot, hs)
    return SketchStore(codes=codes, cum=cum, hs=hs, mu=mu, rot=rot,
                       iso=torch.tensor(float(iso), device=dev))


def sketch_store_from_numpy(codes, cum, hs, mu, rot, iso,
                            device) -> SketchStore:
    """Copy a sketch store given as numpy arrays (for example one built by
    the reference package, uint32 codes included) onto ``device``."""
    dev = torch.device(device)
    return SketchStore(
        codes=torch.tensor(np.asarray(codes).view(np.int32), device=dev),
        cum=torch.tensor(np.asarray(cum, np.float32), device=dev),
        hs=torch.tensor(np.asarray(hs, np.int32), device=dev),
        mu=torch.tensor(np.asarray(mu, np.float32), device=dev),
        rot=torch.tensor(np.asarray(rot, np.float32), device=dev),
        iso=torch.tensor(float(np.asarray(iso)), dtype=torch.float32,
                         device=dev))


def sketch_queries(x: torch.Tensor, store: SketchStore
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode queries on the store's grid → ``(codes, cum)``."""
    return sketch_encode(x, store.mu, store.rot, store.hs)


def lb_guard(d: int) -> float:
    """The rounding guard's per-energy factor ``_GUARD + _GUARD_PER_DIM·d``
    in f32 arithmetic (the f32 value the bound multiplies by)."""
    return float(np.float32(_GUARD) + np.float32(_GUARD_PER_DIM)
                 * np.float32(d))


def _lb_from_cum(cq, cc, nq, nc, iso, d: int) -> torch.Tensor:
    """``max(lb₁, lb₂)`` scaled by ``iso`` less the rounding guard
    ``lb_guard(d)·(n_q + n_c)``, clamped at 0."""
    lb1 = cq + cc
    lb2 = nq + nc - 2.0 * torch.sqrt(torch.clamp_min(nq - cq, 0.0)
                                     * torch.clamp_min(nc - cc, 0.0))
    lb = torch.clamp_min(torch.maximum(lb1, lb2), 0.0)
    return torch.clamp_min(iso * lb - lb_guard(d) * (nq + nc), 0.0)


def _checkpoint_index(h: torch.Tensor, hs: torch.Tensor) -> torch.Tensor:
    """Largest k with ``hs[k] ≤ h`` (hs[0] = 0 ⇒ always ≥ 0 for h ≥ 0):
    the reference's count of checkpoints ≤ h, less one, by a binary
    search that builds no (…, K) comparison tensor."""
    return torch.searchsorted(hs, h.contiguous(), right=True,
                              out_int32=True) - 1


def _dim(hs: torch.Tensor, dim: int | None) -> int:
    """The true dimension ``hs[-1]`` (``dim`` saves the device read)."""
    return int(hs[-1]) if dim is None else dim


def sketch_lower_bound_pairwise(h, cum_q, cum_c, hs, iso, *,
                                dim: int | None = None) -> torch.Tensor:
    """(B, N) Hamming counts → (B, N) certified lower bounds on ‖x−y‖²;
    ``cum_q`` (B, K) and ``cum_c`` (N, K) are the slack tables."""
    kidx = _checkpoint_index(h, hs).long()                 # (B, N)
    cq = torch.gather(cum_q, 1, kidx)
    cc = torch.gather(cum_c.T, 0, kidx)
    return _lb_from_cum(cq, cc, cum_q[:, -1:], cum_c[None, :, -1], iso,
                        _dim(hs, dim))


def sketch_lower_bound_rowwise(h, cum_q, cum_cands, hs, iso, *,
                               dim: int | None = None) -> torch.Tensor:
    """(B, K) Hamming counts over gathered candidates → certified lower
    bounds; ``cum_cands`` (B, K, Kc) are the candidates' slack tables."""
    kidx = _checkpoint_index(h, hs).long()
    cq = torch.gather(cum_q, 1, kidx)
    cc = torch.gather(cum_cands, 2, kidx[..., None])[..., 0]
    return _lb_from_cum(cq, cc, cum_q[:, -1:], cum_cands[..., -1], iso,
                        _dim(hs, dim))


def sketch_lower_bound_gather(h, cum_q, cum_table, cand, hs, iso, *,
                              dim: int | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, K) Hamming counts + candidate ids → ``(lb, norms)``, reading
    only the two slack entries a candidate needs (the checkpoint at ``h``
    and the norm: 8 bytes) from the (N, Kc) table in one gather. Slots
    whose count is negative (NO_NODE, see ``ops.gather_hamming``) or whose
    id is outside the table give +inf for both."""
    Kc = cum_table.shape[1]
    valid = (h >= 0) & (cand >= 0) & (cand < cum_table.shape[0])
    safe = torch.where(valid, cand, 0).long()
    kidx = _checkpoint_index(h, hs).clamp_min(0).long()
    both = torch.take(cum_table,
                      torch.stack([safe * Kc + kidx, safe * Kc + Kc - 1]))
    cq = torch.gather(cum_q, 1, kidx)
    lb = _lb_from_cum(cq, both[0], cum_q[:, -1:], both[1], iso,
                      _dim(hs, dim))
    return (torch.where(valid, lb, math.inf),
            torch.where(valid, both[1], math.inf))


def sketch_survivors(x, store: SketchStore, theta: float) -> np.ndarray:
    """(B, N) numpy bool: which store rows the sketch tier *cannot* certify
    out of θ-range for each query row, ``lb(x_b, y_n) ≤ θ²``.

    The LSH selectivity primitive behind ``plan.LshEstimator``: the mask
    is a certified superset of the true in-range mask (the lower bounds
    never reject a true pair), so per-query survivor counts bound the
    band occupancy from above. The queries (numpy or a tensor) are
    encoded, Hamming-compared (``ops.pairwise_hamming``) and bounded on
    the store's device."""
    from repro_torch.kernels import ops
    dev = store.codes.device
    if isinstance(x, torch.Tensor):
        xt = x.to(device=dev, dtype=torch.float32)
    else:
        xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    qcodes, qcum = sketch_queries(xt, store)
    h = ops.pairwise_hamming(qcodes, store.codes)
    lb = sketch_lower_bound_pairwise(h, qcum, store.cum, store.hs, store.iso,
                                     dim=store.dim)
    return (lb <= float(np.float32(theta) ** 2)).cpu().numpy()
