"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its entry points run on the card unless the caller names the CPU."""
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs.vectorjoin import make_engine
from repro_torch.engine import JoinEngine
from repro_torch.launch import join as launch_join
from repro_torch.configs import get
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import serve_join as launch_serve_join
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.serve import JoinService, ServeEngine
from repro_torch.train import Trainer

ROOT = Path(__file__).resolve().parents[1]
MODULES = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the port's CPU tests run many small ops, and
    with the suite's parallel workers on every core, thread-pool regions
    waiting for descheduled threads slow them tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
        "             or m.startswith(('jax.', 'repro.', 'jaxlib')))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert "repro_torch.kernels.ops" in MODULES and len(MODULES) >= 20
    assert {"repro_torch.quant.sketch", "repro_torch.quant.pdx",
            "repro_torch.quant.cascade", "repro_torch.core.ordering",
            "repro_torch.serve.join_service",
            "repro_torch.plan.planner",
            "repro_torch.core.distributed",
            "repro_torch.models.layers", "repro_torch.models.attention",
            "repro_torch.models.ssm", "repro_torch.models.blocks",
            "repro_torch.models.model", "repro_torch.configs.registry",
            "repro_torch.configs.gemma2_9b", "repro_torch.launch.serve",
            "repro_torch.serve.engine", "repro_torch.train.loop",
            "repro_torch.optim.adamw", "repro_torch.optim.schedule",
            "repro_torch.optim.compress", "repro_torch.checkpoint.ckpt",
            "repro_torch.data.pipeline", "repro_torch.launch.train"
            } <= set(MODULES)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_the_cpu_by_default(no_cuda):
    Y = np.zeros((8, 4), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        JoinEngine(Y)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine(Y, "ci")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_join.main(["--n-data", "50", "--n-query", "4", "--dim", "8"])
    svc = JoinService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svc.load("t", Y)
    assert svc.tenants == []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve_join.main(["--n-data", "50", "--dim", "8",
                                "--requests", "2", "--max-request", "4"])
    assert svc.load("t", Y, engine_kw=dict(device="cpu")).Y.device.type \
        == "cpu"
    eng = JoinEngine(Y, device="cpu")                 # named: allowed
    assert eng.Y.device.type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32


def test_lm_entry_points_refuse_the_cpu_by_default(no_cuda):
    mc = get("tinyllama_1_1b").smoke
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_params(mc)
    model = M.init_params(mc, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.params_from_numpy(mc, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(mc, model, n_slots=1, s_max=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "tinyllama_1_1b", "--smoke"])
    assert ServeEngine(mc, model, n_slots=1, s_max=8,
                       device="cpu").device.type == "cpu"   # named: allowed
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction


def test_training_entry_points_refuse_the_cpu_by_default(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(step_fn=None, source=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "tinyllama_1_1b", "--smoke"])
    assert Trainer(step_fn=None, source=None,
                   device="cpu").device.type == "cpu"       # named: allowed


def test_launcher_on_cpu_reports_recall(capsys):
    assert launch_join.main(["--device", "cpu", "--n-data", "1200",
                             "--n-query", "64", "--dim", "16",
                             "--engine-spec", "ci", "--theta-q", "3"]) == 0
    out = capsys.readouterr().out
    assert "sound=True" in out and "recall=" in out


def test_chip_smoke_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
