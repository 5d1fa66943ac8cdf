"""The port's training loss and grads against the JAX package, on the CPU,
in f32: the dense and frontend archs (``test_torch_train_grads_moe.py``
holds MoE, MLA and the recurrent mixers).

For each arch's smoke config (``with_overrides(dtype=f32)``) the
reference's own weights (``params_from_numpy``) and a batch made from a
seed (targets −1 at the end of lane 0, not counted) go through the
reference's ``loss_fn`` under ``jax.value_and_grad`` (compiled, excess
precision off) and the port's ``loss_fn`` under autograd: total, loss,
aux and ntok, and every grad leaf (the port's carried back with
``params_to_numpy``), within rtol = atol = 1e-4, at remat ``none``,
``full`` and ``2level``. Also ``dot_f32``'s cotangents against
``dot_general``'s on bf16 operands, and the training forward against the
serving forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_ref import (F32_TOL, _f32_params, check_grads, check_loss, configs,
                    port_train, t, train_reference)
from repro_torch.models import layers as L
from repro_torch.models import model as M

ARCHS = ("tinyllama_1_1b", "llama3_405b", "h2o_danube_3_4b", "gemma2_9b",
         "hubert_xlarge", "qwen2_vl_72b")
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
    check_loss(ref, port_train(ref))


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch, remat):
    ref = train_reference(arch, remat)
    got = port_train(ref)
    check_loss(ref, got)
    check_grads(ref, got)


def test_training_forward_is_the_serving_forward():
    """``train_forward`` under autograd gives ``forward``'s hidden states
    (inference mode) at every remat."""
    ref = train_reference("gemma2_9b", "full")
    b = {k: t(v) for k, v in ref["batch"].items()}
    want = M.forward(M.params_from_numpy(ref["pc"], ref["tree"], "cpu"),
                     b["inputs"], b["positions"])
    for remat in REMATS:
        pc = ref["pc"].with_overrides(remat=remat)
        model = M.params_from_numpy(pc, ref["tree"], "cpu")
        model.requires_grad_(True)
        h, aux = M.train_forward(model, b["inputs"], b["positions"])
        assert h.requires_grad and float(aux) == 0.0
        torch.testing.assert_close(h.detach(), want, rtol=0, atol=0)


def test_unknown_remat_raises():
    ref = train_reference("tinyllama_1_1b", "full")
    model = M.params_from_numpy(ref["pc"].with_overrides(remat="some"),
                                ref["tree"], "cpu")
    with pytest.raises(ValueError, match="remat"):
        M.train_forward(model, t(ref["batch"]["inputs"]),
                        t(ref["batch"]["positions"]))


def test_dot_f32_cotangents_match_dot_general():
    """bf16 operands: ``dot_f32``'s CPU route and ``_MmF32.backward`` (the
    card route's backward, called here on CPU tensors) give the
    reference's ``dot_general(preferred_element_type=f32)`` cotangents,
    bit for bit."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 40)) / 8).astype(np.float32)
    g = rng.normal(size=(3, 5, 40)).astype(np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, b: jax.lax.dot_general(
        a, b, (((2,), (0,)), ((), ())), preferred_element_type=jnp.float32),
        jx, jw)
    want = [np.asarray(c, np.float32) for c in vjp(jnp.asarray(g))]
    tx, tw = t(x).bfloat16(), t(w).bfloat16()
    xr, wr = tx.clone().requires_grad_(True), tw.clone().requires_grad_(True)
    out = L.dot_f32(xr, wr)
    assert out.dtype == torch.float32
    out.backward(t(g))
    for got, w_ in zip((xr.grad, wr.grad), want):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), w_)

    class Ctx:
        saved_tensors = (tx.reshape(15, 64), tw)
        needs_input_grad = (True, True)
    gx, gw = L._MmF32.backward(Ctx, t(g).reshape(15, 40))
    np.testing.assert_array_equal(gx.reshape(3, 5, 64).float().numpy(),
                                  want[0])
    np.testing.assert_array_equal(gw.float().numpy(), want[1])


def test_params_to_numpy_inverts_params_from_numpy():
    """The inverse carry gives back the reference's tree exactly, layers
    stacked on the group axis (gemma2: a period of 2)."""
    jc, pc = configs("gemma2_9b", "f32")
    tree = jax.tree.map(np.asarray, _f32_params("gemma2_9b"))
    back = M.params_to_numpy(pc, M.params_from_numpy(pc, tree, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
