"""The port's LM zoo against the JAX package, on the CPU, in bf16 (each
smoke config's own dtype): ``test_torch_lm.py``'s forward, prefill and
ragged-decode cases (``lm_ref``) within the reference's own
decode-vs-forward tolerance, rtol = atol = 3e-2."""
import pytest
import torch

from lm_ref import (DECODABLE, _f32_params, check_forward,
                    check_prefill_and_decode, reference)
from repro_torch.configs import ARCH_IDS


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
def test_forward_matches_reference_bf16(arch):
    check_forward(reference(arch, "bf16"))


@pytest.mark.parametrize("arch", DECODABLE)
def test_prefill_and_ragged_decode_match_reference_bf16(arch):
    check_prefill_and_decode(reference(arch, "bf16"))
