"""The port's roofline machinery (``repro_torch.roofline``) against the JAX
package's.

``CostCounter`` counts the port's eager ops as ``repro.roofline.hlo_cost``
counts HLO: ten products in a loop are exactly ten products' FLOPs, nested
4 × 5 loops twenty, a gradient between two and four forwards (the
expectations of ``tests/test_roofline.py``). Under DTensor it counts one
rank's share and its collectives, not the global op nor DTensor's
shape-inference ops. Collective records shaped like the reference test's
HLO give the reference's wire bytes, and ``analyze`` the reference's
roofline on the same cost and hardware.
"""
import collections

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro.roofline import analyze as jax_analyze
from repro.roofline import collective_stats as jax_collective_stats
from repro.roofline.hw import HWSpec as JaxHWSpec
from repro_torch.launch.mesh import close_group, open_fake_group
from repro_torch.roofline import (CollectiveRecord, HWSpec, analyze,
                                  collective_stats, format_table)
from repro_torch.roofline.cost import Cost, CostCounter

MM_FLOPS = 2 * 64 * 256 * 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(requires_grad=False):
    g = torch.Generator().manual_seed(0)
    w = torch.randn(256, 256, generator=g) / 16
    x = torch.randn(64, 256, generator=g)
    return w.requires_grad_(requires_grad), x


def _loop(w, x, n=10):
    h = x
    for _ in range(n):
        h = torch.tanh(h @ w)
    return h


def test_loop_flops_exact():
    w, x = _inputs()
    with CostCounter() as cc:
        _loop(w, x)
    assert cc.flops == 10 * MM_FLOPS


def test_nested_loop_flops_exact():
    w, x = _inputs()
    with CostCounter() as cc:
        h = x
        for _ in range(4):
            h = _loop(w, h, 5)
    assert cc.flops == 20 * MM_FLOPS


def test_grad_flops_roughly_triple():
    w, x = _inputs(requires_grad=True)
    with CostCounter() as fwd:
        _loop(w, x)
    with CostCounter() as both:
        (g,) = torch.autograd.grad((_loop(w, x) ** 2).sum(), [w])
    assert 2.0 * fwd.flops <= both.flops <= 4.0 * fwd.flops


def test_bytes_and_peak():
    """Every op's operands and result; views move nothing; the peak holds
    the tracked tensors and the live results (512-byte blocks)."""
    x = torch.ones(1024)                         # 4 KiB
    with CostCounter() as cc:
        cc.track(x)
        y = x * 2                                # read 4 KiB, write 4 KiB
        z = y.view(32, 32)                       # a view: nothing
        del y
        w = z + 1                                # 8 KiB more
    assert cc.bytes == 4 * 4096
    assert cc.bytes_min == 4 * 4096              # x, y read once; y, w written
    assert cc.peak_bytes == 3 * 4096
    del z, w


def test_dtensor_local_share_and_collectives():
    """A (256, 4096) × (4096, 4096) product on a fake (32, 8) mesh: the
    counter sees one rank's local product and the all-reduce DTensor runs,
    not the global 8.59e9 FLOPs nor the shape inference."""
    open_fake_group(256)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from torch._subclasses.fake_tensor import FakeTensorMode
        mesh = init_device_mesh("cpu", (32, 8),
                                mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(256, 4096), mesh,
                                  [Shard(0), Shard(1)], src_data_rank=None)
            w = distribute_tensor(torch.empty(4096, 4096), mesh,
                                  [Replicate(), Shard(0)],
                                  src_data_rank=None)
            with CostCounter() as cc:
                y = (x @ w).redistribute(mesh, [Shard(0), Replicate()])
        assert cc.flops == 2 * 8 * 512 * 4096
        assert collective_stats(cc.cost.coll).by_kind_count == {
            "all-reduce": 1}
        rec, n = next(iter(cc.cost.coll.items()))
        assert (rec.group, rec.size, n) == (8, 8 * 4096 * 4, 1)
        assert tuple(y.to_local().shape) == (8, 4096)
    finally:
        close_group()


def test_collective_wire_math_equals_reference():
    """Records shaped like ``tests/test_roofline.py``'s HLO."""
    hlo = """
ENTRY %main (p: f32[1024]) -> f32[1024] {
  %p = f32[1024]{0} parameter(0)
  %ar = f32[1024]{0} all-reduce(%p), replica_groups=[16,16]<=[256], to_apply=%add
  %ag = f32[4096]{0} all-gather(%ar), replica_groups={{0,1,2,3}}, dimensions={0}
  %rs = f32[256]{0} reduce-scatter(%ag), replica_groups={{0,1,2,3}}, to_apply=%add
  ROOT %cp = f32[1024]{0} collective-permute(%p), source_target_pairs={{0,1}}
}
"""
    records = [CollectiveRecord("all-reduce", 4096, 16),
               CollectiveRecord("all-gather", 16384, 4),
               CollectiveRecord("reduce-scatter", 1024, 4),
               CollectiveRecord("collective-permute", 4096, 2)]
    ref = jax_collective_stats(hlo)
    port = collective_stats(collections.Counter(records))
    assert port.by_kind_count == ref.by_kind_count
    assert port.by_kind == pytest.approx(ref.by_kind, rel=1e-12)
    assert port.wire_bytes == pytest.approx(ref.wire_bytes, rel=1e-12)
    counted = collective_stats(Cost(coll={r: 2 for r in records}).coll)
    assert counted.wire_bytes == pytest.approx(2 * ref.wire_bytes, rel=1e-12)
    assert counted.by_kind_count == {k: 2 * n
                                     for k, n in ref.by_kind_count.items()}


def test_cost_algebra():
    a = Cost(1.0, 2.0, 3.0, 4, {CollectiveRecord("all-gather", 8, 2): 1})
    b = Cost(10.0, 20.0, 30.0, 40, {CollectiveRecord("all-gather", 8, 2): 3})
    assert (a + b * 2 - b).flops == 11.0
    assert (a + b * 2 - b).coll[CollectiveRecord("all-gather", 8, 2)] == 4
    assert (b - a).n_ops == 36


@pytest.mark.parametrize("cost", [
    {"flops": 197e12, "bytes accessed": 1e9},
    {"flops": 1e12, "bytes accessed": 5e12, "bytes min": 1e12},
    {"flops": 3e13, "bytes accessed": 2e11, "bytes min": 1.5e11}])
@pytest.mark.parametrize("wire", [0.0, 2e12])
def test_analyze_equals_reference(cost, wire):
    """The same cost, collectives and hardware → the reference's roofline
    (the port's spec names its link term ``link_bw``)."""
    jhw = JaxHWSpec()
    hw = HWSpec(name=jhw.name, peak_flops_bf16=jhw.peak_flops_bf16,
                hbm_bw=jhw.hbm_bw, link_bw=jhw.ici_link_bw,
                hbm_bytes=jhw.hbm_bytes)

    # one collective-permute moves its size over the wire
    kinds = {"collective-permute": wire} if wire else {}

    class Coll:
        wire_bytes = wire
        collectives = kinds
        collective_counts = {k: 1 for k in kinds}

    port_cost = Cost(flops=cost["flops"], bytes=cost["bytes accessed"],
                     bytes_min=cost.get("bytes min", cost["bytes accessed"]),
                     coll=collections.Counter(
                         {CollectiveRecord("collective-permute", int(wire),
                                           2): 1} if wire else {}))
    kw = dict(arch="a", shape="s", mesh_name="m", n_devices=4,
              model_flops=4 * 197e12, peak_memory=1e9)
    ref = jax_analyze(hw=jhw, cost=cost, collective_override=Coll(),
                      **kw).as_dict()
    port = analyze(hw=hw, cost=port_cost, **kw).as_dict()
    for k, v in ref.items():
        assert port[k] == (pytest.approx(v, rel=1e-12)
                           if isinstance(v, float) else v), k
    assert "h100" in analyze(cost=port_cost, **kw).as_dict()["hw"]


def test_format_table():
    r = analyze(arch="tinyllama_1_1b", shape="train_4k", mesh_name="32x8",
                n_devices=256, cost=Cost(flops=1e13), model_flops=1e15)
    lines = format_table([r]).splitlines()
    assert len(lines) == 3 and lines[2].startswith("tinyllama_1_1b")
