"""The port's LM dry run (``repro_torch.launch.dryrun``) against the JAX
package's, on the CPU.

``input_specs`` gives the reference's shapes and dtypes for every
supported (arch, shape) cell. On a fake (2, 4) mesh the per-device
product FLOPs of the tinyllama, qwen3-moe and jamba smoke configs' train
step (jamba's Mamba scan priced whole) are within 10% of the reference's ``analyze_hlo`` of its compiled step on
a (2, 4) mesh (a subprocess with 8 forced host devices); memory and wire
bytes are printed beside them, not held, because two partitioners chose
them. The depth and micro-batch extrapolation of ``trace_cost`` gives a
full trace's FLOPs, bytes and collectives exactly. The CLI runs a
full-width cell, and a join cell, on the CPU and closes its fake group.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import SHAPES as JSHAPES
from repro.configs import get as jax_get
from repro.configs import input_specs as jax_input_specs
from repro.configs import supported as jax_supported
from repro_torch.configs import ARCH_IDS, SHAPES, get, input_specs, supported
from repro_torch.configs.registry import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (close_group, make_local_mesh,
                                     open_fake_group)
from repro_torch.models import model as M
from repro_torch.roofline import (analyze, collective_stats,
                                  model_flops_estimate)

ROOT = Path(__file__).resolve().parents[1]
SMOKE_ARCHS = ("tinyllama_1_1b", "qwen3_moe_235b_a22b",
               "jamba_1_5_large_398b")
SMOKE_SHAPE = ShapeSpec("train_32", "train", 32, 8)
SMOKE_MICRO = 2
FLOPS_RTOL = 0.10

_REF = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from repro.configs import get
    from repro.configs.registry import ShapeSpec
    from repro.launch.dryrun import _memory_bytes, _train_artifacts
    from repro.roofline.hlo_cost import analyze_hlo
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for arch in sys.argv[2:]:
        low = _train_artifacts(get(arch).smoke, mesh,
                               ShapeSpec("train_32", "train", 32, 8),
                               microbatches=2)
        comp = low.compile()
        hc = analyze_hlo(comp.as_text())
        out[arch] = dict(flops=hc.flops, bytes=hc.bytes,
                         bytes_min=hc.bytes_min, wire=hc.wire_bytes,
                         memory=_memory_bytes(comp))
    json.dump(out, open(sys.argv[1], "w"))
""")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def mesh24():
    open_fake_group(8)
    try:
        yield make_local_mesh(4, device_type="cpu")
    finally:
        close_group()


def _jdtype(dt) -> str:
    return np.dtype(dt).name


def _tdtype(dt) -> str:
    return str(dt).removeprefix("torch.")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_reference(arch):
    jmc, mc = jax_get(arch).model, get(arch).model
    for name in SHAPES:
        ok, _ = supported(get(arch), name)
        assert ok == jax_supported(jax_get(arch), name)[0]
        if not ok:
            continue
        ref = jax_input_specs(jmc, JSHAPES[name])
        port = input_specs(mc, SHAPES[name])
        assert set(port) == set(ref), (arch, name)
        for k, v in port.items():
            if k == "caches":
                P = len(mc.period)
                for i, layer in enumerate(v):
                    want = ref["caches"][i % P]
                    assert set(layer) == set(want)
                    for n, t in layer.items():
                        assert tuple(t.shape) == want[n].shape[1:], (n, i)
                        assert _tdtype(t.dtype) == _jdtype(want[n].dtype)
                continue
            assert tuple(v.shape) == ref[k].shape, (arch, name, k)
            assert _tdtype(v.dtype) == _jdtype(ref[k].dtype), (arch, name, k)
            assert v.device.type == "meta"


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_dryrun") / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _REF, str(out), *SMOKE_ARCHS],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_smoke_flops_match_reference(arch, reference, mesh24):
    mc = get(arch).smoke
    cost, peak = dryrun.trace_cost(mc, mesh24, SMOKE_SHAPE,
                                   microbatches=SMOKE_MICRO, device="cpu")
    ref = reference[arch]
    print(f"{arch}: flops/dev port {cost.flops:.6g} reference "
          f"{ref['flops']:.6g}; bytes {cost.bytes:.6g} / {ref['bytes']:.6g};"
          f" bytes_min {cost.bytes_min:.6g} / {ref['bytes_min']:.6g}; wire "
          f"{collective_stats(cost.coll).wire_bytes:.6g} / "
          f"{ref['wire']:.6g}; peak {peak:.6g} / "
          f"memory_analysis {ref['memory']:.6g}")
    assert cost.flops == pytest.approx(ref["flops"], rel=FLOPS_RTOL)
    tokens = SMOKE_SHAPE.batch * SMOKE_SHAPE.seq
    r = analyze(arch=arch, shape=SMOKE_SHAPE.name, mesh_name="2x4",
                n_devices=8, cost=cost,
                model_flops=model_flops_estimate(
                    kind="train", n_params_active=M.active_param_count(mc),
                    tokens=tokens),
                peak_memory=peak)
    assert 0.5 <= r.useful_ratio <= 1.0, r.useful_ratio


@pytest.mark.parametrize("kind,remat,G", [
    ("train", "full", 4), ("train", "2level", 4), ("train", "2level", 9),
    ("prefill", "full", 4), ("decode", "full", 4)])
def test_extrapolation_equals_full_trace(kind, remat, G, mesh24):
    """G layer groups (and four micro-batches of a train step), traced
    whole and extrapolated from 1 and 2 groups of 2 micro-batches
    (2level, chunks of 2 and 3 groups: plus one 4-group trace, whose 2
    chunks of 2 give its extra forwards): the FLOPs and collectives agree
    exactly; the ops too but under 2level, the bytes but for the metrics'
    means (a few bytes a micro-batch: 1e-5); under 2level the ops and
    bytes within 1% (a chunk's own bookkeeping, its aux sum, is counted
    with each extra forward); the write-once bytes within 1%, the peaks
    within 10%."""
    mc = get("tinyllama_1_1b").smoke.with_overrides(n_layers=G, remat=remat)
    shape = ShapeSpec(kind, kind, 16 if kind == "train" else 64, 16)
    mb = 4 if kind == "train" else 1
    cost, peak = dryrun.trace_cost(mc, mesh24, shape, microbatches=mb,
                                   device="cpu")
    full, _, full_peak, _ = dryrun._trace(mc, mesh24, shape, microbatches=mb,
                                          seq_parallel=False, device="cpu",
                                          max_ops=None)
    assert cost.flops == full.flops
    assert cost.coll == full.coll
    rel = 1e-5 if remat == "full" else 1e-2
    if remat == "full":
        assert cost.n_ops == full.n_ops
    assert cost.n_ops == pytest.approx(full.n_ops, rel=rel)
    assert cost.bytes == pytest.approx(full.bytes, rel=rel)
    # a storage's first read is not repeated by a repeat (the f32 grad
    # accumulators are first read by the second micro-batch only)
    assert cost.bytes_min == pytest.approx(full.bytes_min, rel=1e-2)
    print(f"{kind}/{remat}: peak extrapolated {peak} traced {full_peak}")
    assert peak == pytest.approx(full_peak, rel=0.10)


def test_fit_microbatches():
    assert dryrun.fit_microbatches(16, 256, 32) == 8
    assert dryrun.fit_microbatches(2, 256, 32) == 2
    assert dryrun.fit_microbatches(8, 256, 64) == 4
    assert dryrun.fit_microbatches(4, 1, 32) == 1


def test_cli_full_width_cell(tmp_path, capsys):
    out = tmp_path / "cell.json"
    assert dryrun.main(["--arch", "tinyllama_1_1b", "--shape", "decode_32k",
                        "--device", "cpu", "--out", str(out)]) == 0
    assert not dist.is_initialized()
    (r,) = json.loads(out.read_text())
    assert r["mesh"] == "32x8" and r["n_devices"] == 256
    assert r["flops_per_device"] > 0 and r["peak_memory_bytes"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert "tinyllama_1_1b × decode_32k on 32x8" in capsys.readouterr().out


def test_cli_skips_and_join(tmp_path):
    out = tmp_path / "cell.json"
    assert dryrun.main(["--arch", "hubert_xlarge", "--shape", "decode_32k",
                        "--device", "cpu", "--out", str(out)]) == 0
    assert json.loads(out.read_text())[0]["skipped"]
    assert dryrun.main(["--join", "join_sift_like", "--device", "cpu",
                        "--out", str(out)]) == 0
    (r,) = json.loads(out.read_text())
    assert r["arch"] == "join_sift_like" and r["mesh"] == "32x8"
    assert r["flops_per_device"] > 0 and r["expected_iters"] == 32
    assert not dist.is_initialized()


def test_seq_parallel_same_products_smaller_boundaries(mesh24):
    """Sequence parallelism (the hidden state's sequence over the model
    axis) runs the same products and saves boundaries a quarter the size
    on a 4-way model axis."""
    mc = get("tinyllama_1_1b").smoke.with_overrides(n_layers=4)
    shape = ShapeSpec("train_64", "train", 64, 8)
    base, p0 = dryrun.trace_cost(mc, mesh24, shape, microbatches=2,
                                 device="cpu")
    sp, p1 = dryrun.trace_cost(mc, mesh24, shape, microbatches=2,
                               device="cpu", seq_parallel=True)
    assert sp.flops == base.flops
    rs = lambda c: collective_stats(c.coll).by_kind_count.get(
        "reduce-scatter", 0)
    assert rs(sp) > rs(base)
    assert p1 < p0
