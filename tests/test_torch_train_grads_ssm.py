"""The port's training loss and grads against the JAX package, on the CPU,
in f32: the recurrent mixers, jamba (Mamba with MoE layers and attention)
and rwkv6, as ``test_torch_train_grads.py`` does for the dense archs.
"""
import pytest
import torch

from lm_ref import (_f32_params, check_grads, check_loss, port_train,
                    train_reference)

ARCHS = ("jamba_1_5_large_398b", "rwkv6_7b")
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
    assert (got["aux"] > 0.5) == (arch == "jamba_1_5_large_398b")


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch, remat):
    ref = train_reference(arch, remat)
    got = port_train(ref)
    check_loss(ref, got)
    check_grads(ref, got)
