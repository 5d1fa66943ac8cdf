"""The port's continuous-batching ``ServeEngine`` and its serving launcher
against the JAX package, on the CPU, in f32.

Both engines serve the same requests with two slots on the reference's
weights (``params_from_numpy``): prompts of 5, 12 and 19 tokens (19 + the
new tokens run past gemma2's and h2o-danube's window of 16), an overlong
and an empty prompt (both rejected and counted), qwen2-vl on frames. The
greedy tokens, ``done``, ``failed`` and every ``serve.*`` gauge must be
equal. Sampled decoding (which cannot repeat JAX's random bits) is
checked for determinism and for independence from the other lanes. The
launcher on the CPU prints the JAX launcher's token lists on the same
weights.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lm_ref import configs
from repro.launch import serve as jax_launch
from repro.models import model as JM
from repro.obs.metrics import Metrics as JaxMetrics
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get
from repro_torch.launch import serve as launch
from repro_torch.models import model as M
from repro_torch.obs.metrics import Metrics
from repro_torch.serve import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("gemma2_9b", "h2o_danube_3_4b", "deepseek_v2_236b",
         "jamba_1_5_large_398b", "rwkv6_7b", "qwen2_vl_72b")
S_MAX, MAX_NEW = 32, 6
LENGTHS = (5, 19, 12, 5, 19)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread beside the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def prompts(mc, seed: int) -> list[np.ndarray]:
    """LENGTHS prompts, then an overlong and an empty one."""
    rng = np.random.default_rng(seed)
    out = []
    for n in LENGTHS + (S_MAX - MAX_NEW + 1, 0):
        if mc.input_kind == "embeddings":
            out.append(rng.normal(size=(n, mc.frontend_dim)).astype(
                np.float32))
        else:
            out.append(rng.integers(0, mc.vocab, n).astype(np.int32))
    return out


class WaitedServeEngine(JaxServeEngine):
    """The reference's engine, each decode step waited for. Its ``step``
    passes ``jnp.asarray(self.lengths)`` and then writes ``self.lengths``
    before the step's logits are read; on the CPU, JAX takes a 64-byte
    aligned numpy array without a copy, so a step still queued can read
    the next lengths (its jamba run below gave other tokens one run in
    three). Waiting gives the step the lengths it was called with."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        decode = self._decode
        self._decode = lambda *x: jax.block_until_ready(decode(*x))


def served(eng, request_cls, prs, **kw):
    done = eng.run([request_cls(uid=i, prompt=p, max_new=MAX_NEW, **kw)
                    for i, p in enumerate(prs)])
    return done, dict(eng.failed), dict(eng.stats)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(arch):
    jc, pc = configs(arch, "f32")
    params = JM.init_params(jax.random.key(11), jc)
    model = M.params_from_numpy(pc, jax.tree.map(np.asarray, params), "cpu")
    prs = prompts(pc, 12)
    want = served(WaitedServeEngine(jc, params, n_slots=2, s_max=S_MAX,
                                    metrics=JaxMetrics()), JaxRequest, prs)
    eng = ServeEngine(pc, model, n_slots=2, s_max=S_MAX, metrics=Metrics(),
                      device="cpu")
    got = served(eng, Request, prs)
    assert got[0] == want[0]
    assert got[1] == want[1] and sorted(got[1]) == [len(LENGTHS),
                                                    len(LENGTHS) + 1]
    assert got[2] == want[2]
    assert {k: v for k, v in eng.metrics_snapshot()["gauges"].items()} == {
        f"serve.{k}": v for k, v in got[2].items()}


def test_sampled_decoding_is_deterministic_and_lane_independent():
    pc = get("tinyllama_1_1b").smoke.with_overrides(dtype=torch.float32)
    model = M.init_params(pc, device="cpu",
                          generator=torch.Generator().manual_seed(4))
    prs = prompts(pc, 13)[:4]

    def run(prs, slots):
        eng = ServeEngine(pc, model, n_slots=slots, s_max=S_MAX,
                          temperature=0.8, seed=9, metrics=Metrics(),
                          device="cpu")
        return served(eng, Request, prs)[0]

    both = run(prs, 2)
    assert both == run(prs, 2)
    assert both[0] == run(prs[:1], 1)[0]
    assert both[3] == run([np.zeros(0, np.int32)] * 3 + prs[3:], 2)[3]
    greedy = ServeEngine(pc, model, n_slots=2, s_max=S_MAX,
                         metrics=Metrics(), device="cpu")
    assert served(greedy, Request, prs)[0] != both      # sampling sampled


def test_encoder_only_has_no_engine():
    mc = get("hubert_xlarge").smoke
    with pytest.raises(ValueError, match="encoder-only"):
        ServeEngine(mc, None, n_slots=1, s_max=8, device="cpu")


def _lines(out: str) -> list[str]:
    """The launcher's lines without its times."""
    return [re.sub(r" in [0-9.]+s \([0-9.]+ tok/s\)", "", ln)
            for ln in out.splitlines()]


def test_launcher_prints_the_reference_tokens(monkeypatch, capsys):
    argv = ["--arch", "tinyllama_1_1b", "--smoke"]
    monkeypatch.setattr(jax_launch, "ServeEngine", WaitedServeEngine)
    assert jax_launch.main(argv) == 0
    want = _lines(capsys.readouterr().out)
    tree = jax.tree.map(np.asarray, JM.init_params(
        jax.random.key(0), jax_launch.get("tinyllama_1_1b").smoke))
    monkeypatch.setattr(launch.M, "init_params", lambda cfg, device,
                        generator: M.params_from_numpy(cfg, tree, device))
    assert launch.main(argv + ["--device", "cpu"]) == 0
    got = _lines(capsys.readouterr().out)
    assert got == want and len(got) == 5 and got[1].startswith("  uid=0: [")


def test_launcher_runs_as_a_module_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "tinyllama_1_1b", "--smoke"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("[serve] 8 requests, 128 tokens in ")
