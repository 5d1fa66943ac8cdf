"""QuantStore — per-dimension-group scaled int8 storage (port of
``repro.quant.store``).

A ``QuantStore`` holds a vector table as symmetric round-to-nearest int8
codes on one f32 scale per group of ``group_size`` consecutive dimensions,
plus the exact per-vector metadata that makes the compression safe for a
threshold join:

  * ``scales`` — (G,) dequantization scales, ``max |v| / 127`` per group;
  * ``norms``  — (N,) squared norms of the *dequantized* rows, so the
    matmul-form identity is exact in the quantized domain;
  * ``err``    — (N,) the exact L2 quantization error ``‖y − ŷ‖`` per row
    (clipping included), which turns quantized distances into certified
    bounds on true distances (``kernels.ops.quant_lower_bound``).

Queries are quantized on the store's grid (``quantize_queries``), so the
int8 kernels compute ``‖x̂ − ŷ‖²`` entirely in the integer domain. The
codes equal the reference's bit for bit (IEEE division, round half to
even, the same clip); norms and errors are f32 reductions and agree to
rounding.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# one dimension group = one int8 kernel group step (per-group scale)
DEFAULT_GROUP_SIZE = 128

_EPS = 1e-12


def arrays_nbytes(*arrays) -> int:
    """Total bytes resident for a set of tensors."""
    return sum(int(a.numel()) * a.element_size() for a in arrays)


@dataclasses.dataclass(frozen=True)
class QuantStore:
    """Compressed companion of a vector table (or ``GraphIndex.vecs``)."""
    q: torch.Tensor          # (N, d) int8 codes
    scales: torch.Tensor     # (G,) f32 per-dimension-group scales
    norms: torch.Tensor      # (N,) f32 squared norms of dequantized rows
    err: torch.Tensor        # (N,) f32 exact L2 quantization error per row
    group_size: int

    @property
    def n_vectors(self) -> int:
        return self.q.shape[0]

    @property
    def dim(self) -> int:
        return self.q.shape[1]

    @property
    def nbytes(self) -> int:
        return arrays_nbytes(self.q, self.scales, self.norms, self.err)


def n_groups(d: int, group_size: int = DEFAULT_GROUP_SIZE) -> int:
    return -(-d // group_size)


def dim_scales(scales: torch.Tensor, d: int, group_size: int) -> torch.Tensor:
    """Expand per-group scales to a per-dimension (d,) vector."""
    return torch.repeat_interleave(scales, group_size)[:d]


def build_store(vecs, *, group_size: int = DEFAULT_GROUP_SIZE,
                scale_rows=None, device=None) -> QuantStore:
    """Quantize a vector table once (index-build time).

    ``vecs`` is a tensor (kept on its device) or an array (placed on
    ``device``, the card when ``None``). ``scale_rows`` optionally masks which rows set the
    per-group scales; rows outside it are still quantized (they may clip,
    which ``err`` records exactly).
    """
    from repro_torch.core.types import resolve_device
    if isinstance(vecs, torch.Tensor):
        v = vecs.float()
    else:
        v = torch.as_tensor(np.asarray(vecs, np.float32),
                            device=resolve_device(device))
    n, d = v.shape
    G = n_groups(d, group_size)
    src = v
    if scale_rows is not None:
        scale_rows = torch.as_tensor(np.asarray(scale_rows, bool),
                                     device=v.device)
        if bool(scale_rows.any()):
            src = v[scale_rows]
    pad = G * group_size - d
    amax = src.abs()
    if pad:
        amax = torch.nn.functional.pad(amax, (0, pad))
    amax = amax.reshape(src.shape[0], G, group_size)
    if src.shape[0]:
        gmax = amax.amax(dim=(0, 2))
    else:
        gmax = torch.zeros(G, device=v.device)
    scales = torch.clamp_min(gmax / 127.0, _EPS).float()
    q, norms, err = quantize_on_grid(v, dim_scales(scales, d, group_size))
    return QuantStore(q=q, scales=scales, norms=norms, err=err,
                      group_size=group_size)


def quantize_on_grid(x: torch.Tensor, sd: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize rows on an existing scale grid (``sd`` per-dim scales).

    Returns ``(q, norms, err)``: int8 codes, dequantized squared norms,
    and the exact per-row L2 error (clipping included) — the one code
    scheme for stores and queries alike."""
    x = x.float()
    q = torch.clamp(torch.round(x / sd), -127, 127).to(torch.int8)
    deq = q.float() * sd
    norms = torch.sum(deq * deq, dim=1)
    resid = x - deq
    err = torch.sqrt(torch.sum(resid * resid, dim=1))
    return q, norms, err


def quantize_queries(x: torch.Tensor, store: QuantStore
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize queries on the store's scale grid → ``(q, norms, err)``."""
    sd = dim_scales(store.scales, x.shape[1], store.group_size)
    return quantize_on_grid(x, sd)


def dequantize(q: torch.Tensor, scales: torch.Tensor,
               group_size: int) -> torch.Tensor:
    """int8 codes → f32 vectors (any leading shape; dims last)."""
    sd = dim_scales(scales, q.shape[-1], group_size)
    return q.float() * sd
