"""The port's sharding rules (``repro_torch.models.sharding``) against the
JAX package's, for all ten architectures at their published widths.

On the reference's meshes (its TPU pod's (16, 16) and (2, 16, 16), as
``repro.core.compat.abstract_mesh`` builds them) every parameter's spec
equals the reference's leaf spec less its leading scan-group ``None`` (the
port's layers are unstacked), and so do the decode caches' specs and
``batch_sharding_for``. On the port's H100 meshes ((32, 8), (2, 32, 8))
every spec divides its dim and a device holds under 40e9 bytes of
parameters (half of 80 GB, as the reference tests 8e9 of its 16 GB).
Nothing here allocates a parameter: shapes come from the ``meta`` device
and ``jax.eval_shape``.
"""
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.core.compat import abstract_mesh
from repro.models import model as JM
from repro.models import sharding as JS
from repro_torch.configs import ARCH_IDS, get
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD
from repro_torch.models import model as M
from repro_torch.models import sharding as S

REF_MESHES = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}
H100_MESHES = {"single": SINGLE_POD, "multi": MULTI_POD}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sizes(shape, names) -> dict:
    return dict(zip(names, shape))


def _canon(spec) -> tuple:
    """A spec as a tuple, singleton axis tuples as their name."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in tuple(spec))


def _ref_leaf(tree, cfg, name: str):
    """The reference leaf a port parameter name belongs to (layer i is
    slice i // P of period member i % P's stacked leaf)."""
    path = name.split(".")
    if path[0] == "layers":
        node = tree["layers"][int(path[1]) % len(cfg.period)]
        for key in path[2:]:
            node = node[key]
        return node, True
    return tree[name], False


@pytest.mark.parametrize("mesh_name", list(REF_MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, mesh_name):
    shape, names = REF_MESHES[mesh_name]
    mesh = abstract_mesh(shape, names)
    jmc = jax_get(arch).model
    pshape = jax.eval_shape(lambda k: JM.init_params(k, jmc),
                            jax.random.key(0))
    ref = JS.param_specs(pshape, mesh)
    mc = get(arch).model
    port = S.param_specs(mc, _sizes(shape, names))
    for name, spec in port.items():
        leaf, stacked = _ref_leaf(ref, mc, name)
        want = _canon(leaf)
        if stacked:
            assert want[0] is None, (name, want)
            want = want[1:]
        assert _canon(spec) == want, (arch, name, spec, want)


@pytest.mark.parametrize("mesh_name", list(H100_MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_h100_specs_divide_and_fit(arch, mesh_name):
    shape, names = H100_MESHES[mesh_name]
    sizes = _sizes(shape, names)
    mc = get(arch).model
    specs = S.param_specs(mc, sizes)
    params = dict(M.Model(mc, M.ParamInit("meta")).named_parameters())
    held = 0
    for name, p in params.items():
        spec = specs[name]
        assert len(spec) == p.dim(), (name, spec)
        denom = 1
        for dim, axes in zip(p.shape, spec):
            n = S._axes_size(sizes, axes)
            assert dim % n == 0, (arch, name, tuple(p.shape), spec)
            denom *= n
        held += p.numel() * p.element_size() // denom
    assert held < 40e9, (arch, held)


@pytest.mark.parametrize("arch", ["llama3_405b", "qwen3_moe_235b_a22b"])
def test_big_weights_are_sharded(arch):
    """No multi-GB parameter is replicated on the H100 mesh."""
    mc = get(arch).model
    specs = S.param_specs(mc, _sizes(*SINGLE_POD))
    for name, p in M.Model(mc, M.ParamInit("meta")).named_parameters():
        if p.numel() * p.element_size() > 1e9:
            assert any(a is not None for a in specs[name]), name


def test_moe_experts_on_model_axis():
    mc = get("qwen3_moe_235b_a22b").model
    for mesh in (REF_MESHES["single"], SINGLE_POD):
        specs = S.param_specs(mc, _sizes(*mesh))
        assert specs["layers.0.ffn.gate"][0] == "model"    # (E, d, f): E → EP
        assert specs["layers.0.ffn.down"][0] == "model"


def test_divisibility_fallback():
    """hubert's 504-way vocab head does not divide the reference's 16-way
    model axis and falls back to replication there; the H100 mesh's
    8-way axis divides it."""
    mc = get("hubert_xlarge").model
    assert S.param_specs(mc, _sizes(*REF_MESHES["single"]))["head"][-1] \
        is None
    assert S.param_specs(mc, _sizes(*SINGLE_POD))["head"][-1] == "model"


@pytest.mark.parametrize("batch,s_max", [(128, 1024), (1, 4096)])
@pytest.mark.parametrize("arch", ["h2o_danube_3_4b", "deepseek_v2_236b",
                                  "jamba_1_5_large_398b"])
def test_cache_specs_equal_reference(arch, batch, s_max):
    shape, names = REF_MESHES["single"]
    mesh = abstract_mesh(shape, names)
    jmc = jax_get(arch).model
    cshape = jax.eval_shape(lambda: JM.init_caches(jmc, batch, s_max))
    ref = JS.cache_specs(cshape, mesh, batch=batch)
    mc = get(arch).model
    port = S.cache_specs(M.init_caches(mc, batch, s_max, "meta"),
                         _sizes(shape, names), batch=batch)
    P_ = len(mc.period)
    for i, layer in enumerate(port):
        want_layer = ref[i % P_]
        for name, spec in layer.items():
            want = _canon(want_layer[name])
            assert want[0] is None
            assert _canon(spec) == want[1:], (arch, i, name, spec, want)


def test_cache_specs_batch_vs_sequence_sharding():
    mc = get("h2o_danube_3_4b").model
    sizes = _sizes(*SINGLE_POD)
    k = S.cache_specs(M.init_caches(mc, 128, 1024, "meta"), sizes,
                      batch=128)[0]["k"]                   # (B, W, K, hd)
    assert k[0] == "data" and k[1] == "model"
    k1 = S.cache_specs(M.init_caches(mc, 1, 4096, "meta"), sizes,
                       batch=1)[0]["k"]
    assert k1[0] is None and k1[1] == ("data", "model")


@pytest.mark.parametrize("mesh_name", list(REF_MESHES))
def test_batch_sharding_for_equals_reference(mesh_name):
    shape, names = REF_MESHES[mesh_name]
    mesh = abstract_mesh(shape, names)
    for leaf in [(256, 4096), (1, 524288), (128, 1), (32, 32768, 3),
                 (128,), (2, 8, 4)]:
        sds = jax.ShapeDtypeStruct(leaf, np.int32)
        want = _canon(JS.batch_sharding_for(mesh, sds).spec)
        want = want + (None,) * (len(leaf) - len(want))
        got = S.batch_sharding_for(_sizes(shape, names),
                                   torch.empty(leaf, device="meta"))
        assert _canon(got) == want, (leaf, got, want)
        assert S.batch_spec(_sizes(shape, names), len(leaf)) == _canon(
            JS.batch_spec(mesh, len(leaf))) + (None,) * (
            len(leaf) - len(tuple(JS.batch_spec(mesh, len(leaf)))))


def test_placements_over_pod_and_data():
    """A dim over (pod, data) is Shard(d) on both mesh dims; a DTensor of
    that spec on a fake 512-rank mesh holds 1/64 of the dim."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.mesh import close_group, open_fake_group
    open_fake_group(512)
    try:
        mesh = init_device_mesh("cpu", (2, 32, 8),
                                mesh_dim_names=("pod", "data", "model"))
        pl = S.placements((("pod", "data"), "model"), mesh)
        assert pl == (Shard(0), Shard(0), Shard(1))
        assert S.placements((None, None), mesh) == (Replicate(),) * 3
        t = S.place(torch.empty((4096, 64), device="meta"), mesh, pl)
        assert tuple(t.to_local().shape) == (4096 // 64, 64 // 8)
        assert math.prod(mesh.shape) == 512
    finally:
        close_group()
