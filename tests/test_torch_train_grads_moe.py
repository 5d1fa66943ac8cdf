"""The port's training loss and grads against the JAX package, on the CPU,
in f32: the MoE archs (with the load-balancing aux loss; deepseek-v2's
MLA), as ``test_torch_train_grads.py`` does for the dense ones
(``test_torch_train_grads_ssm.py``: Mamba and RWKV6); and
``moe_aux_loss`` itself, with tied router probabilities.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_ref import (F32_TOL, _f32_params, check_grads, check_loss, configs,
                    port_train, t, train_reference)
from repro.models import layers as JL
from repro_torch.models import layers as L
from repro_torch.models import model as M

ARCHS = ("deepseek_v2_236b", "qwen3_moe_235b_a22b")
REMATS = ("none", "full", "2level")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread beside the suite's parallel workers; the
    module's references are dropped at its end."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    train_reference.cache_clear()
    _f32_params.cache_clear()


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch):
    ref = train_reference(arch, "full")
    got = port_train(ref)
    check_loss(ref, got)
    assert got["aux"] > 0.5              # the MoE aux loss is counted


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch, remat):
    ref = train_reference(arch, remat)
    got = port_train(ref)
    check_loss(ref, got)
    check_grads(ref, got)


@pytest.mark.parametrize("tie", [False, True])
def test_moe_aux_loss_matches_reference(tie):
    """The Switch aux loss and its router grad, with router columns 0 and
    1 made equal (``tie``): tied probabilities count for the lower expert,
    as ``lax.top_k`` orders them."""
    mcfg = configs("qwen3_moe_235b_a22b", "f32")[0].period[0].moe
    tree = jax.tree.map(np.asarray, _f32_params("qwen3_moe_235b_a22b"))
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"][0]["ffn"])
    if tie:
        jp["router"] = jp["router"].at[:, 1].set(jp["router"][:, 0])
    x = np.random.default_rng(9).normal(
        size=(2, 24, mcfg.d_model)).astype(np.float32)
    want, g_want = jax.value_and_grad(
        lambda r: JL.moe_aux_loss(dict(jp, router=r), jnp.asarray(x), mcfg))(
        jp["router"])
    moe = L.MoE(mcfg, torch.float32, L.ParamInit("meta")).to_empty(
        device="cpu")
    with torch.no_grad():
        moe.router.copy_(t(np.asarray(jp["router"])))
    moe.router.requires_grad_(True)
    got = L.moe_aux_loss(moe, t(x))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **F32_TOL)
    np.testing.assert_allclose(moe.router.grad.numpy(), np.asarray(g_want),
                               **F32_TOL)
