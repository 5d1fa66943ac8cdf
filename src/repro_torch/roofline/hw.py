"""Target-hardware constants (NVIDIA H100 SXM) for the roofline analysis
(port of ``repro.roofline.hw``, whose target is a TPU v5e)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HWSpec:
    """Per-device peaks (NVIDIA H100 SXM data sheet).

    ``link_bw`` is the single link term of the reference's collective
    model, one rate for every collective: the per-GPU inter-node NIC, one
    400 Gb/s NIC per GPU on a DGX H100 node = 50e9 B/s per direction,
    which the data-axis collectives cross. The model axis stays inside a
    node, on NVLink (450e9 B/s per direction per GPU), so its collectives
    are priced pessimistically, 9× too slow."""
    name: str = "h100-sxm"
    peak_flops_bf16: float = 989e12     # dense, per GPU
    hbm_bw: float = 3.35e12             # bytes/s per GPU (HBM3)
    link_bw: float = 50e9               # bytes/s per direction (NIC)
    hbm_bytes: float = 80e9             # per-GPU capacity


H100 = HWSpec()
