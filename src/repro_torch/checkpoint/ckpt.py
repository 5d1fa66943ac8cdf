"""Checkpoint/restart (port of ``repro.checkpoint.ckpt``), in the
reference's on-disk format: one ``.npy`` per leaf, named by its path in
the tree (keys joined by ``__``), plus a JSON manifest (names, dtypes,
structure, timestamp).

  * **Off the critical path.** ``save`` copies every leaf to the host
    before it returns, then writes and fsyncs on a worker thread, so the
    next step runs while the disk works. The copy must finish first: the
    port updates parameters and optimizer states in place, and a write
    that read them later would race the next step.
  * **Atomic commit.** Writes go to ``step_<n>.tmp/`` and are renamed to
    ``step_<n>/`` once every array and the manifest are fsynced; a crash
    mid-save never corrupts the newest checkpoint, and restore takes the
    newest committed step.
  * **Restart-exact data.** The step is the directory's name; the data
    pipeline is indexed by step.
  * **Heartbeats.** A small ``heartbeat.json``, replaced atomically each
    step, for an outside liveness or straggler monitor.

A tree is nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or numbers. numpy has no bfloat16 (and the card's host no
``ml_dtypes``), so bf16 and float8 leaves are stored as same-width
unsigned views and the manifest records the real dtype, as the reference
does.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

_SEP = "__"

# dtypes numpy cannot hold: stored as same-width unsigned integer views →
# (the dtype, the torch integer type it is viewed through, the numpy type
# stored on disk)
_VIEW_DTYPES = {
    "bfloat16": (torch.bfloat16, torch.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8),
}
_TORCH_TO_NUMPY = {torch.int16: np.int16, torch.uint8: np.uint8}


def _flatten(tree, path=()):
    """(path, leaf) pairs in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (str(i),))
    else:
        yield path, tree


def _unflatten(like, leaves: dict, path=()):
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, path + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves, path + (str(i),))
                          for i, v in enumerate(like))
    return leaves[path]


def _structure(tree):
    """The tree with every leaf replaced by ``*`` (the manifest's record)."""
    if isinstance(tree, dict):
        return {str(k): _structure(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return "*"


def _name(path) -> str:
    return _SEP.join(path) or "leaf"


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A leaf copied to host memory → (numpy array to write, real dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        dt = str(t.dtype).removeprefix("torch.")
        if dt in _VIEW_DTYPES:
            return t.view(_VIEW_DTYPES[dt][1]).numpy().view(
                _VIEW_DTYPES[dt][2]), dt
        return t.numpy(), dt
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write(host: list, structure, directory: str) -> None:
    os.makedirs(directory)
    names, dtypes = [], {}
    for name, (arr, dt) in host:
        names.append(name)
        dtypes[name] = dt
        with open(os.path.join(directory, name + ".npy"), "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
    manifest = dict(names=names, dtypes=dtypes, treedef=json.dumps(structure),
                    timestamp=time.time())
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(directory)


def _host_tree(tree) -> list:
    return [(_name(path), _to_host(leaf)) for path, leaf in _flatten(tree)]


def save_tree(tree, directory: str) -> None:
    """Serialize a tree of tensors or arrays into ``directory`` (which must
    not exist)."""
    _write(_host_tree(tree), _structure(tree), directory)


def restore_tree(directory: str, like, *, device=None):
    """Load a tree saved by ``save_tree`` (or by the reference's) in the
    structure of ``like`` (tensors or arrays; each leaf's shape is
    checked). Leaves come back as tensors of the stored dtype, on the CPU
    or on ``device``."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {}
    for path, leaf in _flatten(like):
        name = _name(path)
        arr = np.load(os.path.join(directory, name + ".npy"))
        dt = manifest.get("dtypes", {}).get(name)
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{name}: stored {arr.shape}, expected "
                             f"{tuple(leaf.shape)}")
        if dt in _VIEW_DTYPES:
            dtype, view, _ = _VIEW_DTYPES[dt]
            t = torch.from_numpy(arr.view(_TORCH_TO_NUMPY[view])).view(dtype)
        else:
            t = torch.from_numpy(arr)
        leaves[path] = t if device is None else t.to(device)
    return _unflatten(like, leaves)


class CheckpointManager:
    """Step-indexed checkpoint directory with async atomic saves."""

    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- paths --------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:010d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp") \
                    and os.path.isfile(os.path.join(self.root, name,
                                                    "manifest.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    # -- save ---------------------------------------------------------
    def wait(self) -> None:
        """Block until the in-flight save (if any) commits; raise its
        error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree, *, blocking: bool = False) -> None:
        """Snapshot ``tree`` at ``step``: every leaf is copied to the host
        now; writing and committing happen on a worker thread."""
        self.wait()
        if os.path.isdir(self._step_dir(step)):      # already committed
            return
        host, structure = _host_tree(tree), _structure(tree)

        def work():
            try:
                final = self._step_dir(step)
                tmp = final + ".tmp"
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                _write(host, structure, tmp)
                os.rename(tmp, final)                 # atomic commit
                _fsync_dir(self.root)
                self._gc()
            except BaseException as e:               # surfaced by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        for name in os.listdir(self.root):            # orphaned tmp dirs
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)

    # -- restore ------------------------------------------------------
    def restore(self, like, *, step: int | None = None, device=None):
        """(step, tree) of the newest (or the given) committed step."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.root}")
        return step, restore_tree(self._step_dir(step), like, device=device)

    # -- liveness -----------------------------------------------------
    def heartbeat(self, step: int, **info) -> None:
        path = os.path.join(self.root, "heartbeat.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dict(step=step, time=time.time(), **info), f)
        os.replace(tmp, path)

    def read_heartbeat(self) -> dict | None:
        path = os.path.join(self.root, "heartbeat.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)
