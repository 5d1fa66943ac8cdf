"""The port's checkpoint manager against the reference's cases
(``tests/test_checkpoint.py``), on the CPU: the bf16 round trip, the save
off the critical path, keep-k, a crash mid-save, a missing step and the
heartbeat; the on-disk format read across the two packages both ways; and
the host copy that a save makes before it returns (the port updates its
tensors in place, so a save must not see a later step)."""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_tree as jax_restore_tree
from repro.checkpoint import save_tree as jax_save_tree
from repro_torch.checkpoint import CheckpointManager, restore_tree, save_tree


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return dict(
        w=torch.randn(8, 16, generator=g),
        b=torch.randn(4, generator=g).bfloat16(),
        layers=(dict(q=torch.arange(12, dtype=torch.int32).reshape(3, 4)),),
        step=torch.tensor(7, dtype=torch.int32),
    )


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, torch.Tensor))


def test_roundtrip_including_bf16(tmp_path):
    t = _tree()
    save_tree(t, str(tmp_path / "ck"))
    back = restore_tree(str(tmp_path / "ck"), t)
    assert isinstance(back["layers"], tuple)
    for a, b in zip(_leaves(t), _leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_manager_save_restore_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    mgr.save(10, t)
    mgr.save(20, t)           # waits for the previous save internally
    mgr.wait()
    assert mgr.steps() == [10, 20]
    step, back = mgr.restore(t)
    assert step == 20
    assert torch.equal(back["w"], t["w"])


def test_save_copies_to_the_host_before_it_returns(tmp_path):
    """In-place writes after ``save`` returns (the next optimizer step)
    never reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    want = {k: v.clone() for k, v in t.items() if k != "layers"}
    mgr.save(1, t)
    with torch.no_grad():
        t["w"].add_(1.0)
        t["b"].mul_(2)
    mgr.wait()
    _, back = mgr.restore(t)
    assert torch.equal(back["w"], want["w"])
    assert torch.equal(back["b"], want["b"])


def test_gc_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, t, blocking=True)
    assert mgr.steps() == [3, 4]


def test_crash_mid_save_never_corrupts(tmp_path):
    """A stray .tmp dir (a simulated crash) is invisible to restore and
    cleaned by the next save."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    t = _tree()
    mgr.save(5, t, blocking=True)
    os.makedirs(str(tmp_path / "step_0000000009.tmp"))
    assert mgr.latest_step() == 5
    step, _ = mgr.restore(t)
    assert step == 5
    mgr.save(6, t, blocking=True)
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore(_tree())


def test_restore_checks_shapes(tmp_path):
    t = _tree()
    save_tree(t, str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="w: stored"):
        restore_tree(str(tmp_path / "ck"), dict(t, w=torch.zeros(4, 4)))


def test_a_failed_save_raises_at_the_next_wait(tmp_path):
    """The worker's error (here: a file where its .tmp directory goes)
    surfaces at the next ``wait``, once."""
    mgr = CheckpointManager(str(tmp_path))
    (tmp_path / "step_0000000003.tmp").write_text("")
    mgr.save(3, _tree())
    with pytest.raises(NotADirectoryError):
        mgr.wait()
    mgr.wait()                                   # raised once
    assert mgr.steps() == []


def test_heartbeat(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.read_heartbeat() is None
    mgr.heartbeat(42, loss=1.5)
    hb = mgr.read_heartbeat()
    assert hb["step"] == 42 and hb["loss"] == 1.5


def test_restore_onto_a_device(tmp_path):
    """The reference restores onto explicit shardings (elastic restore);
    the port onto an explicit device."""
    t = _tree()
    save_tree(t, str(tmp_path / "ck"))
    back = restore_tree(str(tmp_path / "ck"), t, device="cpu")
    assert all(x.device.type == "cpu" for x in _leaves(back))


def _jax_tree():
    k = jax.random.key(0)
    return dict(
        w=jax.random.normal(k, (8, 16), jnp.float32),
        b=jax.random.normal(k, (4,), jnp.bfloat16),
        layers=(dict(q=jnp.arange(12, dtype=jnp.int32).reshape(3, 4)),),
        step=jnp.int32(7),
    )


def test_the_port_reads_the_reference_checkpoint(tmp_path):
    t = _jax_tree()
    jax_save_tree(t, str(tmp_path / "ck"))
    like = jax.tree.map(lambda a: torch.zeros(a.shape), t)
    back = restore_tree(str(tmp_path / "ck"), like)
    assert back["b"].dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(t), _leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())


def test_the_reference_reads_the_port_checkpoint(tmp_path):
    t = _tree()
    save_tree(t, str(tmp_path / "ck"))
    back = jax_restore_tree(str(tmp_path / "ck"), _jax_tree())
    assert back["b"].dtype == ml_dtypes.bfloat16
    assert back["step"].dtype == np.int32 and back["step"].shape == ()
    for a, b in zip(_leaves(t), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
