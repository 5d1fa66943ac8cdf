"""The port's training loop, data pipeline and launcher against the JAX
package, on the CPU, on tinyllama's smoke config (as the reference's
``tests/test_train_serve.py`` drives its own).

Both trainers start from the reference's weights (``params_from_numpy``)
and read the same ``SyntheticLM`` batches; the reference's step is
compiled with excess precision off (``lm_ref.compiled``). Tolerances: in
f32 the loss, lr and grad-norm histories over 30 steps within 1e-5 and
the final parameters within 1e-5 (measured: 1.5e-6, 2.3e-10, 4.8e-7 and
5.7e-7); in bf16 the loss history within 5e-3 (measured 1.3e-3: bf16
rounding of sums taken in another order). Batches are bit for bit.
"""
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_ref import compiled
from repro.configs import get as jax_get
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.data.pipeline import TokenFileSource as JaxTokenFileSource
from repro.launch import train as jax_launch
from repro.models import model as JM
from repro.optim import adamw as jax_adamw
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.train.loop import Trainer as JaxTrainer
from repro.train.loop import TrainState as JaxTrainState
from repro.train.loop import make_train_step as jax_make_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.configs import get
from repro_torch.data.pipeline import SyntheticLM, TokenFileSource
from repro_torch.launch import train as launch
from repro_torch.models import model as M
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train import Trainer, TrainState, make_train_step

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = dict(rtol=0, atol=1e-5)
BF16_LOSS_TOL = dict(rtol=0, atol=5e-3)
STEPS = 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(dtype: str):
    jc, pc = jax_get("tinyllama_1_1b").smoke, get("tinyllama_1_1b").smoke
    if dtype == "f32":
        jc = jc.with_overrides(dtype=jnp.float32)
        pc = pc.with_overrides(dtype=torch.float32)
    return jc, pc


def _lr(pkg=warmup_cosine):
    return pkg(peak_lr=2e-3, warmup_steps=3, total_steps=40)


def _src(cls=SyntheticLM):
    return cls(vocab=256, seq_len=24, global_batch=8, seed=4)


def _port(pc, tree, microbatches=1, **kw):
    """(state, trainer) of the port on the reference's weights."""
    model = M.params_from_numpy(pc, tree, "cpu")
    opt = adamw(weight_decay=0.0)
    state = TrainState(params=model,
                       opt_state=opt.init(dict(model.named_parameters())))
    step = make_train_step(pc, opt, _lr(), microbatches=microbatches)
    kw.setdefault("log", lambda s: None)
    return state, Trainer(step_fn=step, source=_src(), device="cpu", **kw)


_REFS = {}


def _reference(dtype: str, microbatches: int = 1):
    """The reference's weights, its compiled step and its 30-step history
    (once a module)."""
    key = (dtype, microbatches)
    if key not in _REFS:
        jc, _ = _configs(dtype)
        params = JM.init_params(jax.random.key(4), jc)
        opt = jax_adamw(weight_decay=0.0)
        batch = jax.tree.map(jnp.asarray, _src(JaxSyntheticLM).batch_at(0))
        step = compiled(jax_make_train_step(
            jc, opt, _lr(jax_warmup_cosine), microbatches=microbatches),
            params, opt.init(params), batch, jnp.int32(0))
        tree = jax.tree.map(np.asarray, params)
        st, hist = JaxTrainer(step_fn=step, source=_src(JaxSyntheticLM),
                              log=lambda s: None).run(
            JaxTrainState(params=params, opt_state=opt.init(params)), STEPS)
        _REFS[key] = dict(tree=tree, step=step, opt=opt, hist=hist,
                          params=jax.tree.map(np.asarray, st.params))
    return _REFS[key]


def _col(hist, k):
    return np.array([h[k] for h in hist])


def test_loss_decreases():
    _, pc = _configs("bf16")
    state, tr = _port(pc, _reference("bf16")["tree"])
    _, hist = tr.run(state, STEPS)
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.5


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_loss_history_matches_reference(dtype):
    ref = _reference(dtype)
    _, pc = _configs(dtype)
    state, tr = _port(pc, ref["tree"])
    state, hist = tr.run(state, STEPS)
    assert [h["step"] for h in hist] == list(range(STEPS))
    if dtype == "bf16":
        np.testing.assert_allclose(_col(hist, "loss"), _col(ref["hist"],
                                                            "loss"),
                                   **BF16_LOSS_TOL)
        return
    for k in ("loss", "aux", "ntok", "lr", "grad_norm"):
        np.testing.assert_allclose(_col(hist, k), _col(ref["hist"], k),
                                   **F32_TOL, err_msg=k)
    got = M.params_to_numpy(pc, state.params)
    for a, b in zip(jax.tree.leaves(ref["params"]), jax.tree.leaves(got)):
        np.testing.assert_allclose(b, a, **F32_TOL)


def test_grad_accum_equivalent_and_matches_reference():
    """microbatches 1 against 4 on one step (the reference test's bounds),
    and the port's 4-micro-batch step against the reference's in f32."""
    ref = _reference("f32", microbatches=4)
    _, pc = _configs("f32")
    batch = {k: torch.from_numpy(v) for k, v in _src().batch_at(0).items()}
    out = {}
    for n in (1, 4):
        state, tr = _port(pc, ref["tree"], microbatches=n)
        _, _, m = tr.step_fn(state.params, state.opt_state, batch, 0)
        out[n] = (M.params_to_numpy(pc, state.params), m)
    np.testing.assert_allclose(float(out[1][1]["loss"]),
                               float(out[4][1]["loss"]), rtol=2e-2)
    assert max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(out[1][0]), jax.tree.leaves(out[4][0]))) < 0.05
    params = jax.tree.map(jnp.asarray, ref["tree"])
    jp, _, jm = ref["step"](params, ref["opt"].init(params), jax.tree.map(
        jnp.asarray, _src(JaxSyntheticLM).batch_at(0)), jnp.int32(0))
    for k in ("loss", "aux", "ntok", "grad_norm"):
        np.testing.assert_allclose(float(out[4][1][k]), float(jm[k]),
                                   **F32_TOL)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(out[4][0])):
        np.testing.assert_allclose(b, np.asarray(a), **F32_TOL)


def test_fault_recovery_resumes_from_checkpoint(tmp_path):
    """The reference test's run on the port: 12 steps with a checkpoint
    every 5, then a new trainer restores step 12 and a node failure at
    step 15 is retried from the step-15 checkpoint; the losses after it
    are the uninterrupted run's, bit for bit (restart-exact)."""
    _, pc = _configs("f32")
    tree = _reference("f32")["tree"]
    _, full = _port(pc, tree)[1].run(_port(pc, tree)[0], 20)
    ck = CheckpointManager(str(tmp_path), keep=2)
    state, tr = _port(pc, tree, ckpt=ck, ckpt_every=5)
    tr.run(state, 12)
    calls = {"n": 0}
    logs = []

    def fault(s):
        if s == 15 and calls["n"] == 0:
            calls["n"] += 1
            raise RuntimeError("injected node failure")

    state2, tr2 = _port(pc, tree, ckpt=ck, ckpt_every=5, fault_hook=fault,
                        log=logs.append)
    state2 = tr2.restore_or_init(state2)
    assert state2.step == 12
    state2, hist = tr2.run(state2, 20)
    assert state2.step == 20 and calls["n"] == 1
    assert logs[0] == f"[trainer] restored step 12 from {tmp_path}"
    assert any("step 15 attempt 0 failed" in ln for ln in logs)
    assert [h["step"] for h in hist] == list(range(12, 20))
    np.testing.assert_array_equal(_col(hist, "loss"),
                                  _col(full, "loss")[12:])
    assert ck.read_heartbeat()["step"] == 20 and ck.latest_step() == 20


def test_retry_overwrites_the_in_place_parameters(tmp_path, monkeypatch):
    """A step that fails after writing into the model (a crash mid-update)
    is retried on the checkpoint's parameters and optimizer state, copied
    back into the same tensors; the step-4 save is still being written
    when step 6 crashes (each write is held back 0.5 s), and is waited
    for."""
    write = ckpt_mod._write

    def slow_write(*a):
        time.sleep(0.5)
        write(*a)

    monkeypatch.setattr(ckpt_mod, "_write", slow_write)
    _, pc = _configs("f32")
    tree = _reference("f32")["tree"]
    _, full = _port(pc, tree)[1].run(_port(pc, tree)[0], 8)
    state, tr = _port(pc, tree, ckpt=CheckpointManager(str(tmp_path)),
                      ckpt_every=4)
    inner, calls = tr.step_fn, {"n": 0}

    def crashing(model, opt_state, batch, step):
        if step == 6 and calls["n"] == 0:
            calls["n"] += 1
            with torch.no_grad():
                model.embed.mul_(3.0)
                opt_state["mu"]["head"].fill_(9.0)
            raise RuntimeError("crash mid-update")
        return inner(model, opt_state, batch, step)

    tr.step_fn = crashing
    embed = state.params.embed
    state, hist = tr.run(state, 8)
    assert state.params.embed is embed and calls["n"] == 1
    assert [h["step"] for h in hist] == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7]
    np.testing.assert_array_equal(_col(hist, "loss")[-4:],
                                  _col(full, "loss")[4:])


@pytest.mark.parametrize("with_ckpt", [False, True])
def test_failed_step_with_nothing_to_restore_is_raised(tmp_path, with_ckpt):
    """A step that fails after its in-place update, with no checkpoint
    manager or with none committed yet (the first save would come at step
    100), is raised after one attempt: a retry would step again on top of
    the failed step's writes."""
    _, pc = _configs("f32")
    tree = _reference("f32")["tree"]
    kw = (dict(ckpt=CheckpointManager(str(tmp_path)), ckpt_every=100)
          if with_ckpt else {})
    state, tr = _port(pc, tree, **kw)
    inner, calls = tr.step_fn, {"n": 0}

    def crashing(model, opt_state, batch, step):
        out = inner(model, opt_state, batch, step)
        if step == 2:
            calls["n"] += 1
            raise RuntimeError("crash after the update")
        return out

    tr.step_fn = crashing
    with pytest.raises(RuntimeError, match="crash after the update"):
        tr.run(state, 4)
    assert calls["n"] == 1 and int(state.opt_state["step"]) == 3


def test_fault_before_the_step_is_retried_without_a_checkpoint():
    """A node failure in the fault hook, before the step ran, with no
    checkpoint: the step is retried on the state it found, as the
    reference retries, and the losses are the uninterrupted run's."""
    _, pc = _configs("f32")
    tree = _reference("f32")["tree"]
    _, full = _port(pc, tree)[1].run(_port(pc, tree)[0], 4)
    calls, logs = {"n": 0}, []

    def fault(s):
        if s == 2 and calls["n"] == 0:
            calls["n"] += 1
            raise RuntimeError("injected node failure")

    state, tr = _port(pc, tree, fault_hook=fault, log=logs.append)
    state, hist = tr.run(state, 4)
    assert state.step == 4 and calls["n"] == 1
    assert any("step 2 attempt 0 failed" in ln for ln in logs)
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    np.testing.assert_array_equal(_col(hist, "loss"), _col(full, "loss"))


def test_straggler_watchdog_and_heartbeats(tmp_path, monkeypatch):
    """A step three times slower than the running median is counted and
    logged; every step writes a heartbeat. The loop's clock is a fake one
    that each step advances by its own duration, so load on the machine
    cannot make another step a straggler."""
    class Clock:
        t = 0.0

        def perf_counter(self):
            return self.t

    clock = Clock()
    monkeypatch.setattr("repro_torch.train.loop.time", clock)
    logs = []

    def step_fn(model, opt_state, batch, step):
        clock.t += 0.25 if step == 7 else 1 / 64      # exact in binary
        return model, opt_state, dict(loss=torch.tensor(1.0))

    ck = CheckpointManager(str(tmp_path), keep=1)
    tr = Trainer(step_fn=step_fn, source=_src(), ckpt=ck, ckpt_every=100,
                 log=logs.append, device="cpu")
    model = M.init_params(get("tinyllama_1_1b").smoke, device="cpu")
    _, hist = tr.run(TrainState(params=model, opt_state={}), 9)
    assert [h["stragglers"] for h in hist] == [0] * 7 + [1, 1]
    assert [h["seconds"] for h in hist][6:8] == [1 / 64, 0.25]
    assert any(ln.startswith("[trainer] straggler step 7: 0.250s vs "
                             "median 0.016s") for ln in logs)
    assert ck.read_heartbeat()["step"] == 9 and ck.steps() == [9]


# -- the data pipeline ---------------------------------------------------------

@pytest.mark.parametrize("pos_dims", [1, 3])
def test_synthetic_batches_equal_reference(pos_dims):
    kw = dict(vocab=97, seq_len=16, global_batch=4, seed=9, pos_dims=pos_dims)
    src, ref = SyntheticLM(**kw), JaxSyntheticLM(**kw)
    for step in (0, 3, 17):
        for rank, world in ((0, 1), (0, 2), (1, 2), (3, 4)):
            a = src.batch_at(step, rank=rank, world=world)
            b = ref.batch_at(step, rank=rank, world=world)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    full = src.batch_at(3)["inputs"]
    halves = [src.batch_at(3, rank=r, world=2)["inputs"] for r in (0, 1)]
    np.testing.assert_array_equal(np.concatenate(halves), full)


def test_frontend_frames_raise_as_in_reference():
    """The reference's frames draw their projection from a negative spawn
    key, which numpy refuses: both packages raise the same error (ROADMAP
    Queue C); the smoke's frame archs take frames made directly."""
    kw = dict(vocab=32, seq_len=8, global_batch=2, frontend_dim=24)
    for cls in (SyntheticLM, JaxSyntheticLM):
        with pytest.raises(ValueError, match="non-negative"):
            cls(**kw).batch_at(0)


@pytest.mark.parametrize("dtype", ["uint16", "uint32"])
def test_token_file_source_equals_reference(tmp_path, dtype):
    toks = (np.arange(10_000) * 7919 % 40_000).astype(dtype)
    path = str(tmp_path / "tokens.bin")
    toks.tofile(path)
    kw = dict(path=path, vocab=30_000, seq_len=16, global_batch=4,
              seed=3, dtype=dtype)
    src, ref = TokenFileSource(**kw), JaxTokenFileSource(**kw)
    assert src.n_chunks() == ref.n_chunks() == 588
    for step in (0, 1, 146, 147, 400):                # 147 steps an epoch
        for rank, world in ((0, 1), (1, 2)):
            a = src.batch_at(step, rank=rank, world=world)
            b = ref.batch_at(step, rank=rank, world=world)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    b0 = src.batch_at(0)
    assert b0["inputs"].shape == (4, 16)
    assert (b0["targets"][:, :-1] == b0["inputs"][:, 1:]).all()


# -- the launcher --------------------------------------------------------------

def _lines(out: str) -> list[str]:
    """The launcher's lines, times cut, and the losses they print."""
    lines = [re.sub(r" [0-9]+ms$", "", ln) for ln in out.splitlines()]
    return ([re.sub(r"[0-9]+\.[0-9]{4}", "L", ln) for ln in lines],
            [float(x) for ln in lines
             for x in re.findall(r"[0-9]+\.[0-9]{4}", ln)])


def test_launcher_prints_the_reference_lines(monkeypatch, capsys):
    """The port's launcher on the reference's weights prints the reference
    launcher's lines (the reference's step compiled as it compiles it:
    excess precision on) with its losses within 5e-3 (bf16)."""
    argv = ["--arch", "tinyllama_1_1b", "--smoke", "--steps", "12"]
    assert jax_launch.main(argv) == 0
    want, want_loss = _lines(capsys.readouterr().out)
    tree = jax.tree.map(np.asarray, JM.init_params(
        jax.random.key(0), jax_launch.get("tinyllama_1_1b").smoke))
    monkeypatch.setattr(launch.M, "init_params", lambda cfg, device,
                        generator: M.params_from_numpy(cfg, tree, device))
    assert launch.main(argv + ["--device", "cpu"]) == 0
    got, got_loss = _lines(capsys.readouterr().out)
    assert got == want and len(got) == 3
    assert got[-1] == "[train] done at step 12; loss L -> L"
    np.testing.assert_allclose(got_loss, want_loss, **BF16_LOSS_TOL)


def test_launcher_resumes_as_a_module_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --device cpu``: a run to step
    10, then a run to step 20 that restores step 10 and goes on (one
    intra-op thread, as in-process: beside the suite's workers torch's
    default pool made each step ~50 times slower)."""
    outs = []
    for steps in (10, 20):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--device",
             "cpu", "--arch", "tinyllama_1_1b", "--smoke", "--steps",
             str(steps), "--ckpt-every", "5", "--ckpt-dir", str(tmp_path),
             "--batch", "4", "--seq", "32", "--optimizer", "adafactor"],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                     OMP_NUM_THREADS="1"))
        assert out.returncode == 0, out.stderr
        outs.append(out.stdout.splitlines())
    assert outs[0][-1].startswith("[train] done at step 10; loss ")
    assert outs[1][0] == f"[trainer] restored step 10 from {tmp_path}"
    assert outs[1][1].startswith("[trainer] step 10 loss=")
    assert outs[1][-1].startswith("[train] done at step 20; loss ")
