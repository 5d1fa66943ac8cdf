"""Training step and fault-tolerant training loop (port of
``repro.train.loop``).

``make_train_step`` builds the step: gradient accumulation over
``microbatches`` into f32 buffers (each micro-batch's grads cast to f32
and summed there, then divided, as the reference's ``lax.scan`` does), the
global grad norm before clipping, and the optimizer's in-place update.

``Trainer`` runs the steps: restore or init from the newest checkpoint
(restart-exact with the step-indexed data pipeline), periodic async
checkpoints, heartbeats, a straggler watchdog (a step slower than
``straggler_factor`` × the running median), a retry that restores the
newest checkpoint into the model after an exception, and a fault hook the
tests use to simulate a node failure. A step that fails is retried on the
state it left only when it failed in the fault hook, before the step ran:
the step updates the model in place, so a failure inside it with no
committed checkpoint to copy back is raised, not retried on a state that
may be half updated.

The port's state is updated in place: ``TrainState.params`` is the
``Model`` itself and ``opt_state`` the optimizer's tensors, so the step
returns the same objects, and a restore copies the checkpoint into them.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.profiler import record_function

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.types import resolve_device
from repro_torch.models import model as M
from repro_torch.models import sharding as S
from repro_torch.optim import Optimizer
from repro_torch.optim.adamw import global_norm


@dataclasses.dataclass
class TrainState:
    params: M.Model
    opt_state: dict
    step: int = 0


def _micro(batch: dict, i: int, n: int) -> dict:
    """Micro-batch i of n (the batch itself when n is 1)."""
    if n == 1:
        return batch
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} micro-batches")
    return {k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}


def _replicated(x):
    """A DTensor metric resolved to a replicated value (a partial sum
    all-reduced), so each micro-batch settles its own."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, (Replicate(),) * x.device_mesh.ndim)


# the profiler span each micro-batch of a training step runs in
MICROBATCH_SPAN = "train_step.microbatch"


def make_train_step(mc: M.ModelConfig, opt: Optimizer,
                    lr_fn: Callable[[int], float], *, microbatches: int = 1,
                    loss_fn: Callable | None = None,
                    grad_shardings: dict | None = None,
                    mb_sharding_fn: Callable | None = None):
    """``step(model, opt_state, batch, step) -> (model, opt_state,
    metrics)``: one optimizer step on ``batch`` (a dict of tensors on the
    model's device), updating the model and ``opt_state`` in place.
    ``metrics`` holds device scalars: ``loss``, ``aux`` and ``ntok``
    (means over the micro-batches), ``grad_norm`` (before clipping) and
    ``lr`` (a float). ``mc`` is the model's config (the reference's step
    builds its loss from it).

    On a mesh (the model's parameters DTensors, ``sharded_train_step``):
    grad_shardings: parameter name → placements each micro-batch's grads
      are redistributed to before they are accumulated (DTensor leaves a
      grad as the backward made it, a partial sum over the data axes;
      the reference's pin of its f32 accumulators). mb_sharding_fn(x) ->
      x laid out: applied to each leaf of each micro-batch (of the whole
      batch when ``microbatches`` is 1), as the reference shards its
      (n_micro, b/n, ...) leaves over the data axes.

    Each micro-batch runs in a ``torch.profiler.record_function`` span
    named ``MICROBATCH_SPAN``: a profile shows them, and the dry run's
    cost counter takes one micro-batch's cost from them.
    """
    loss_fn = loss_fn or (lambda model, mb: M.loss_fn(model, mb))

    def place(name, x):
        if grad_shardings is None or not isinstance(x, DTensor):
            return x
        return x.redistribute(x.device_mesh, grad_shardings[name])

    def grads_of(model, batch):
        names = [n for n, _ in model.named_parameters()]
        params = [p for _, p in model.named_parameters()]
        for p in params:
            p.requires_grad_(True)
        acc, ms = None, []
        for i in range(microbatches):
            with record_function(MICROBATCH_SPAN):
                mb = _micro(batch, i, microbatches)
                if mb_sharding_fn is not None:
                    mb = {k: mb_sharding_fn(v) for k, v in mb.items()}
                total, m = loss_fn(model, mb)
                # unused parameters (a frontend arch's token table) get
                # zeros, as jax.grad gives them
                g = torch.autograd.grad(total, params, allow_unused=True,
                                        materialize_grads=True)
                g = [place(n, x) for n, x in zip(names, g)]
                ms.append({k: _replicated(v.detach()) for k, v in m.items()})
                with torch.no_grad():
                    if acc is None:
                        acc = [x.float() for x in g]
                    else:
                        for a, x in zip(acc, g):
                            a.add_(x)
                del g, total
        with torch.no_grad():
            if microbatches > 1:
                for a in acc:
                    a.div_(microbatches)
            metrics = {k: torch.stack([m[k] for m in ms]).float().mean()
                       if microbatches > 1 else ms[0][k] for k in ms[0]}
        return dict(zip(names, acc)), metrics

    def step_fn(model, opt_state, batch, step):
        grads, metrics = grads_of(model, batch)
        lr = lr_fn(step)
        metrics = dict(metrics, lr=lr, grad_norm=global_norm(grads))
        opt.update(grads, opt_state, dict(model.named_parameters()), lr)
        return model, opt_state, metrics

    return step_fn


def _mirror(state, pls: dict, rep: tuple):
    """Placements of an optimizer state: a dict keyed by parameter names
    (AdamW's moments) mirrors the parameters; anything else (the step
    count) is replicated."""
    if isinstance(state, dict) and set(state) == set(pls):
        return dict(pls)
    if isinstance(state, dict):
        return {k: _mirror(v, pls, rep) for k, v in state.items()}
    return rep


def _distribute_state(state: dict, opls: dict, mesh) -> None:
    """Each tensor of ``state`` that is not yet a DTensor replaced, in
    place, by this rank's shard of it (it is the same on every rank)."""
    for k, v in state.items():
        if isinstance(v, dict):
            _distribute_state(v, opls[k], mesh)
        elif isinstance(v, torch.Tensor) and not isinstance(v, DTensor) \
                and v.dim() > 0:
            state[k] = distribute_tensor(v, mesh, opls[k], src_data_rank=None)


def sharded_train_step(mc: M.ModelConfig, opt: Optimizer, lr_fn, mesh, *,
                       microbatches: int = 1, donate: bool = True,
                       seq_parallel: bool = False):
    """The training step on a torch ``DeviceMesh`` (``launch/mesh.py``):
    the port of ``jit_train_step``. Returns ``(step_fn, param_placements,
    opt_placements)``.

    ``step_fn(model, opt_state, batch, step)`` distributes the model's
    parameters and the optimizer state by the rules of
    ``models/sharding.py`` where they are not DTensors yet (each rank holds
    the same full tensors, from one seed, and keeps its shard: nothing is
    sent), shards each micro-batch over the data axes, runs
    ``make_train_step``'s step under the activation sharder with each
    grad redistributed to its parameter's placements, and returns the
    (sharded) model, the optimizer state and the metrics as plain
    tensors. With ``donate`` the model and state given are distributed in
    place (the reference donates its buffers to the jitted step); without
    it, copies are, and the step returns them. The optimizer's state must
    mirror the parameters (AdamW's moments). Constants the model makes
    (RoPE frequencies, masks, zero accumulators) are the same on every
    rank: they enter DTensor ops as replicated."""
    pls = S.param_placements(mc, mesh)
    rep = (Replicate(),) * mesh.ndim
    opls = _mirror(opt.init({n: torch.empty(0) for n in pls}), pls, rep)
    step = make_train_step(mc, opt, lr_fn, microbatches=microbatches,
                           grad_shardings=pls,
                           mb_sharding_fn=lambda x: S.shard_batch(x, mesh))
    sharder = S.make_act_sharder(mesh, seq_parallel=seq_parallel)

    def step_fn(model, opt_state, batch, step_no):
        if not donate:
            model, opt_state = copy.deepcopy(model), copy.deepcopy(opt_state)
        if not isinstance(next(model.parameters()), DTensor):
            S.distribute_model(model, mesh, placements_of=pls)
        _distribute_state(opt_state, opls, mesh)
        with implicit_replication(), M.activation_sharding(
                sharder, S.make_param_pinner(mesh)):
            model, opt_state, metrics = step(model, opt_state, batch,
                                             step_no)
        metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
                   for k, v in metrics.items()}
        return model, opt_state, metrics

    return step_fn, pls, opls


def _copy_into(dst, src) -> None:
    """Copy a restored tree into the live tensors of the same structure."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy_into(d, s)
    else:
        with torch.no_grad():
            dst.copy_(src)


@dataclasses.dataclass
class Trainer:
    """Fault-tolerant loop around a step function. Batches go to
    ``device`` (``None``: the card)."""
    step_fn: Callable                   # (model, opt, batch, step) -> ...
    source: Any                         # .batch_at(step) -> dict of numpy
    ckpt: CheckpointManager | None = None
    ckpt_every: int = 100
    max_retries: int = 2
    straggler_factor: float = 3.0
    fault_hook: Callable[[int], None] | None = None   # tests: raise to sim
    log_every: int = 10
    log: Callable[[str], None] = print
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @staticmethod
    def _tree(state: TrainState) -> dict:
        return dict(params=dict(state.params.named_parameters()),
                    opt_state=state.opt_state)

    def _restore(self, state: TrainState) -> TrainState | None:
        """The newest checkpoint copied into ``state``'s model and
        optimizer state (in place), at its step; None when there is none.
        A save still being written counts: it is waited for, since a retry
        after a failed in-place step must not go on from the tensors that
        step left."""
        if self.ckpt is None:
            return None
        self.ckpt.wait()
        if self.ckpt.latest_step() is None:
            return None
        like = self._tree(state)
        step, tree = self.ckpt.restore(like)
        _copy_into(like, tree)
        self.log(f"[trainer] restored step {step} from {self.ckpt.root}")
        return TrainState(params=state.params, opt_state=state.opt_state,
                          step=step)

    def restore_or_init(self, state: TrainState) -> TrainState:
        """The newest checkpoint copied into ``state`` (in place), at its
        step; ``state`` itself when there is none."""
        return self._restore(state) or state

    def _batch(self, step: int) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in self.source.batch_at(step).items()}

    def run(self, state: TrainState, n_steps: int
            ) -> tuple[TrainState, list[dict]]:
        history: list[dict] = []
        times: list[float] = []
        stragglers = 0
        step = state.step
        while step < n_steps:
            batch = self._batch(step)
            t0 = time.perf_counter()
            for attempt in range(self.max_retries + 1):
                in_step = False
                try:
                    if self.fault_hook is not None:
                        self.fault_hook(step)
                    in_step = True
                    params, opt_state, metrics = self.step_fn(
                        state.params, state.opt_state, batch, step)
                    rec = {k: float(v) for k, v in metrics.items()
                           if np.ndim(v) == 0}      # waits for the step
                    break
                except Exception as e:  # noqa: BLE001 — node-failure path
                    self.log(f"[trainer] step {step} attempt {attempt} "
                             f"failed: {e!r}")
                    if attempt >= self.max_retries:
                        raise
                    back = self._restore(state)
                    if back is None and in_step:
                        raise       # the model may be half updated
                    if back is not None:
                        state, step = back, back.step
                        batch = self._batch(step)
            dt = time.perf_counter() - t0
            # straggler watchdog: flag steps >> running median
            if len(times) >= 5 and dt > self.straggler_factor * float(
                    np.median(times)):
                stragglers += 1
                self.log(f"[trainer] straggler step {step}: {dt:.3f}s vs "
                         f"median {np.median(times):.3f}s")
            times.append(dt)
            state = TrainState(params=params, opt_state=opt_state,
                               step=step + 1)
            rec.update(step=step, seconds=dt, stragglers=stragglers)
            history.append(rec)
            if step % self.log_every == 0:
                self.log(f"[trainer] step {step} loss={rec.get('loss', 0):.4f} "
                         f"{dt * 1e3:.0f}ms")
            if self.ckpt is not None and (step + 1) % self.ckpt_every == 0:
                self.ckpt.save(step + 1, self._tree(state))
                self.ckpt.heartbeat(step + 1, loss=rec.get("loss"))
            elif self.ckpt is not None:
                self.ckpt.heartbeat(step + 1)
            step += 1
        if self.ckpt is not None:
            self.ckpt.save(state.step, self._tree(state), blocking=True)
        return state, history
