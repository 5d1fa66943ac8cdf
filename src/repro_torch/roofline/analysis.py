"""Three-term roofline of one dry-run cell (port of
``repro.roofline.analysis``).

    compute_s    = FLOPs_per_device / peak_FLOP/s
    memory_s     = bytes_per_device / HBM_bw
    collective_s = wire_bytes_per_device / link_bw

The reference reads FLOPs and bytes from the compiled HLO and parses its
collectives from the HLO text. The port reads all three from
``roofline.cost.CostCounter``, which records one rank's local ops under
DTensor, its collectives among them (``CollectiveRecord``). Each
collective's *wire* traffic per device follows the reference's
ring-algorithm factors:

    all-reduce       2 · size · (g−1)/g      (reduce-scatter + all-gather)
    all-gather       size · (g−1)/g          (size = result bytes)
    reduce-scatter   size · g · (g−1)/g      (size = scattered result)
    all-to-all       size · (g−1)/g
    collective-permute   size

where g is the group size. The dominant term is the bottleneck;
``useful_ratio`` compares the analytic model FLOPs (6·N·D train / 2·N·D
inference) against the counted FLOPs to expose remat/redundancy waste.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Mapping

from repro_torch.roofline.hw import H100, HWSpec

if TYPE_CHECKING:
    from repro_torch.roofline.cost import Cost

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    kind: str           # one of KINDS
    size: int           # bytes, by the convention above
    group: int          # group size g


def wire_bytes(rec: CollectiveRecord) -> float:
    g = max(rec.group, 1)
    ring = (g - 1) / g if g > 1 else 0.0
    if rec.kind == "all-reduce":
        return 2.0 * rec.size * ring
    if rec.kind == "all-gather":
        return rec.size * ring
    if rec.kind == "reduce-scatter":
        return rec.size * g * ring
    if rec.kind == "all-to-all":
        return rec.size * ring
    return float(rec.size)                       # collective-permute


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0
    result_bytes: float = 0.0
    count: int = 0
    by_kind: dict[str, float] = dataclasses.field(default_factory=dict)
    by_kind_count: dict[str, int] = dataclasses.field(default_factory=dict)


def collective_stats(records: Mapping[CollectiveRecord, float]
                     ) -> CollectiveStats:
    """Per-device wire bytes of the recorded collectives: ``records`` maps
    each record to how many times it ran (``cost.Cost.coll``)."""
    st = CollectiveStats()
    for rec, n in records.items():
        wire = wire_bytes(rec) * n
        st.wire_bytes += wire
        st.result_bytes += rec.size * n
        st.count += n
        st.by_kind[rec.kind] = st.by_kind.get(rec.kind, 0.0) + wire
        st.by_kind_count[rec.kind] = st.by_kind_count.get(rec.kind, 0) + n
    return st


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    compute_s: float
    memory_s: float              # every op's operands and result
    collective_s: float
    bottleneck: str
    model_flops: float            # analytic 6·N·D or 2·N·D (global)
    useful_ratio: float           # model_flops / (flops_per_device × devices)
    peak_memory_bytes: float      # the tracker's peak on one rank
    memory_min_s: float = 0.0    # write-once/read-once traffic (optimistic)
    collectives: dict[str, float] = dataclasses.field(default_factory=dict)
    collective_counts: dict[str, int] = dataclasses.field(
        default_factory=dict)
    hw: HWSpec = dataclasses.field(default=H100, repr=False)

    @property
    def step_s(self) -> float:
        """Pessimistic roofline step estimate (max term; op-granular
        memory bound)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def step_min_s(self) -> float:
        """Optimistic estimate: write-once/read-once HBM traffic and
        perfect overlap."""
        return max(self.compute_s, self.memory_min_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the step ran at the
        modelled time: useful_flops / (devices·peak·step_min_s)."""
        denom = self.n_devices * self.hw.peak_flops_bf16 * self.step_min_s
        return self.model_flops / denom if denom else 0.0

    def as_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["hw"] = self.hw.name
        d["step_s"] = self.step_s
        d["step_min_s"] = self.step_min_s
        d["roofline_fraction"] = self.roofline_fraction
        return d


def analyze(*, arch: str, shape: str, mesh_name: str, n_devices: int,
            cost: "Cost", model_flops: float, peak_memory: float = 0.0,
            hw: HWSpec = H100) -> Roofline:
    """cost: one device's ``cost.Cost`` (FLOPs, bytes, write-once bytes
    and collectives; the reference reads the first three from the
    compiled HLO and parses its collectives from the HLO text)."""
    flops, byts, byts_min = (float(cost.flops), float(cost.bytes),
                             float(cost.bytes_min))
    st = collective_stats(cost.coll)
    compute_s = flops / hw.peak_flops_bf16
    memory_s = byts / hw.hbm_bw
    memory_min_s = byts_min / hw.hbm_bw
    collective_s = st.wire_bytes / hw.link_bw
    terms = dict(compute=compute_s, memory=memory_s,
                 collective=collective_s)
    bottleneck = max(terms, key=terms.get)
    useful = model_flops / max(flops * n_devices, 1.0)
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        flops_per_device=flops, bytes_per_device=byts,
        wire_bytes_per_device=st.wire_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        memory_min_s=memory_min_s,
        bottleneck=bottleneck, model_flops=model_flops,
        useful_ratio=useful, peak_memory_bytes=peak_memory,
        collectives=st.by_kind, collective_counts=st.by_kind_count, hw=hw)


def model_flops_estimate(*, kind: str, n_params_active: int, tokens: int
                         ) -> float:
    """Analytic MODEL_FLOPS: 6·N·D for training (fwd+bwd), 2·N·D forward."""
    return (6.0 if kind == "train" else 2.0) * n_params_active * tokens


def format_table(rows: list[Roofline]) -> str:
    hdr = (f"{'arch':<22} {'shape':<12} {'mesh':<10} {'comp_s':>9} "
           f"{'mem_s':>9} {'coll_s':>9} {'bound':>7} {'useful':>7} "
           f"{'roofl%':>7} {'GB/dev':>7}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:<22} {r.shape:<12} {r.mesh:<10} {r.compute_s:>9.3g} "
            f"{r.memory_s:>9.3g} {r.collective_s:>9.3g} {r.bottleneck:>7} "
            f"{r.useful_ratio:>7.2f} {100 * r.roofline_fraction:>6.1f}% "
            f"{r.peak_memory_bytes / 1e9:>7.2f}")
    return "\n".join(lines)
