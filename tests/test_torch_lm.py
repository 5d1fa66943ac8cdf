"""The port's LM zoo against the JAX package, on the CPU, in f32.

For every architecture's smoke config (``with_overrides(dtype=f32)`` on
both sides) the same inputs (numpy, from a seed) and the reference's own
weights (``params_from_numpy``) go through both packages (``lm_ref``):
the forward's hidden states and logits (hubert bidirectional, qwen2-vl
on frames with three distinct M-RoPE streams), ``embed_sequence`` (last
and mean), prefill's logits and every cache leaf, four decode steps over
two ragged lanes (prompts of 7 and 20 tokens: 20 passes gemma2's and
h2o-danube's window of 16, so their rings wrap) and the caches after
them, all within rtol = atol = 1e-4. Also: the MoE layer with capacity
drops and with tied router probabilities, the ring prefill of 24 tokens
past gemma2's window, the ten full configs' parameter counts and the
registry's cells. ``test_torch_lm_bf16.py`` holds the bf16 cases.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_ref import (DECODABLE, F32_TOL, _f32_params, check_forward,
                    check_prefill_and_decode, configs, positions, reference,
                    t)
from repro.configs import cells as jax_cells
from repro.configs import get as jax_get
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import ARCH_IDS, cells, get
from repro_torch.models import model as M


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread beside the suite's parallel workers; the
    module's references are dropped at its end."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    reference.cache_clear()
    _f32_params.cache_clear()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_weights_carry_whole(arch):
    """Every leaf carried, each at its own dtype (``params_from_numpy``
    checks both), and the counts agree."""
    ref = reference(arch, "f32")
    model, tree = ref["model"], ref["tree"]
    n = sum(np.asarray(leaf).size for leaf in jax.tree.leaves(tree))
    assert n == sum(prm.numel() for prm in model.parameters())
    assert M.param_count(ref["pc"]) == n


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference(arch):
    check_forward(reference(arch, "f32"))


@pytest.mark.parametrize("arch", DECODABLE)
def test_prefill_and_ragged_decode_match_reference(arch):
    check_prefill_and_decode(reference(arch, "f32"))


@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "deepseek_v2_236b"])
@pytest.mark.parametrize("exact", [False, True])
def test_moe_with_capacity_drops_matches_reference(arch, exact):
    """64 tokens that all route alike put 64 assignments on each of their
    top experts against a capacity of ceil(64·k/E·1.25): the dispatch
    drops (``exact=False``) or keeps (``exact=True``) the same ones."""
    ref = reference(arch, "f32")
    jc = configs(arch, "f32")[0]
    mcfg = jc.period[0].moe
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), ref["tree"]["layers"][0]
                      ["ffn"])
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(1, 1, mcfg.d_model))
         + 0.01 * rng.normal(size=(2, 32, mcfg.d_model))).astype(np.float32)
    T = x.shape[0] * x.shape[1]
    cap = int(np.ceil(T * mcfg.top_k / mcfg.n_experts
                      * mcfg.capacity_factor))
    top = np.argsort(-(x.reshape(T, -1) @ np.asarray(jp["router"])),
                     -1)[:, :mcfg.top_k]
    assert np.bincount(top.ravel()).max() > cap           # drops happen
    want = JL.moe_apply(jp, mcfg, jnp.asarray(x), exact=exact)
    got = ref["model"].layers[0].ffn(t(x), exact=exact)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_moe_ties_go_to_the_lower_expert_as_in_reference():
    """Router columns 0 and 1 made equal: tied probabilities, in the top-k
    or at its edge, go to expert 0 first, as ``lax.top_k`` orders them."""
    ref = reference("qwen3_moe_235b_a22b", "f32")
    jc = configs("qwen3_moe_235b_a22b", "f32")[0]
    mcfg = jc.period[0].moe
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), ref["tree"]["layers"][0]
                      ["ffn"])
    jp["router"] = jp["router"].at[:, 1].set(jp["router"][:, 0])
    moe = ref["model"].layers[0].ffn
    saved = moe.router.clone()
    try:
        with torch.no_grad():
            moe.router[:, 1] = moe.router[:, 0]
        x = np.random.default_rng(6).normal(
            size=(4, 16, mcfg.d_model)).astype(np.float32)
        probs = np.asarray(x.reshape(64, -1) @ np.asarray(jp["router"]))
        rank = np.argsort(np.argsort(-probs, -1, kind="stable"), -1)
        assert ((rank[:, :2] == mcfg.top_k - 1).any(-1)
                & (rank[:, :2] == mcfg.top_k).any(-1)).any()   # at the edge
        want = JL.moe_apply(jp, mcfg, jnp.asarray(x), exact=True)
        got = moe(t(x), exact=True)
    finally:
        with torch.no_grad():
            moe.router.copy_(saved)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_ring_prefill_past_the_window_matches_reference():
    """A 24-token prompt into gemma2's local layers (window 16): positions
    p and p + 16 share a ring slot. The port writes only the last 16 (slot
    p % 16 holds p for p in 8..23); the reference's scatter keeps the same
    tokens, and every cache leaf and the logits agree."""
    ref = reference("gemma2_9b", "f32")
    jc, pc = configs("gemma2_9b", "f32")
    params = jax.tree.map(jnp.asarray, ref["tree"])
    x = np.random.default_rng(7).integers(0, jc.vocab, (1, 24)).astype(
        np.int32)
    p = positions(jc, 1, 24)
    lg_j, c_j = JM.prefill(params, jc, x, p, 32)
    lg, caches = M.prefill(ref["model"], t(x), t(p), 32)
    ring = caches[0]["pos"][0].numpy()
    slots = np.arange(16)
    np.testing.assert_array_equal(ring, np.where(slots < 8, slots + 16, slots))
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_j), **F32_TOL)
    P = len(jc.period)
    for i, c in enumerate(caches):
        for k, v in c.items():
            np.testing.assert_allclose(
                v.float().numpy(), np.asarray(c_j[i % P][k][i // P],
                                              np.float32), **F32_TOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_counts_match_reference(arch):
    jc, pc = jax_get(arch).model, get(arch).model
    assert M.param_count(pc) == JM.param_count(jc)
    assert M.active_param_count(pc) == JM.active_param_count(jc)


def test_registry_cells_match_reference():
    assert cells() == jax_cells()
    assert all(get(a).model.name == jax_get(a).model.name for a in ARCH_IDS)
