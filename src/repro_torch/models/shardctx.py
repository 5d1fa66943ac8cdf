"""Shared activation-sharding context (port of ``repro.models.shardctx``).

Layers deep inside the model consult these hooks so that a launcher can
pin the layouts of their tensors on a mesh. Launchers install a sharder
with ``model.activation_sharding``; without one every hook is the
identity, so the model runs as it does on one device.

The reference's hook is ``shard(x, tag)``, a ``with_sharding_constraint``
that GSPMD propagates from. The port runs on DTensors (``torch.distributed
.tensor``) in eager mode, where each op needs a sharding strategy of its
own, so the sharder answers three calls:

  shard(x, tag)            x redistributed to the tag's layout (the
                           reference's constraint);
  view(x, shape, tag)      x reshaped to ``shape`` and pinned to the tag's
                           layout. DTensor cannot unflatten a dim that is
                           sharded unevenly over the new dims (K kv heads
                           on a model axis larger than K), so the pin sits
                           at the reshape;
  local(tag, fn, *args)    ``fn(*args)`` computed on each rank's shards
                           with the placements the sharder gives for the
                           tag (``local_map``): the explicit strategies of
                           the ops DTensor has none for (the chunked
                           attention's batched products, the MoE dispatch's
                           sort and scatter, the recurrences, the decode
                           cache writes, the vocab-parallel loss).

Tags of ``shard``/``view``:
  hidden   (B, S, d)        batch → data axes [, seq → model if seq_parallel]
  block_in (B, S, d)        batch → data axes (a block's normed input, and
                            the logits' input: a sequence-parallel hidden
                            state gathered before its products)
  logits   (B, S, V)        batch → data, V → model
  qkv      (B, S, H|K, hd)  batch → data, heads → model

The reference's ``moe_eb``/``moe_out`` pins of the MoE's (E, cap, d)
buffers are the ``moe_dispatch``/``moe_combine`` regions here: they always
lay the buffer out with experts over the model axis and capacity slots
over the data axes.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Any, Callable

_SHARD: ContextVar[Any] = ContextVar("repro_torch_shard_hook", default=None)
_PIN: ContextVar[Callable[[Any], Any] | None] = ContextVar(
    "repro_torch_param_pin", default=None)


def set_sharder(fn):
    return _SHARD.set(fn)


def reset_sharder(tok):
    _SHARD.reset(tok)


def set_pin(fn):
    return _PIN.set(fn)


def reset_pin(tok):
    _PIN.reset(tok)


def sharder():
    """The installed sharder (None: none)."""
    return _SHARD.get()


def shard(x, tag: str):
    fn = _SHARD.get()
    return fn(x, tag) if fn is not None else x


def view(x, shape, tag: str):
    fn = _SHARD.get()
    return fn.view(x, shape, tag) if fn is not None else x.reshape(shape)


def local(tag: str, fn, *args, **kw):
    sharder = _SHARD.get()
    if sharder is None:
        return fn(*args, **kw)
    return sharder.local(tag, fn, *args, **kw)


def pin(tree):
    fn = _PIN.get()
    return fn(tree) if fn is not None else tree


def checkpoint_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: the recompute runs under
    the sharder and pinner of the forward that saved it."""
    fn, pin_fn = _SHARD.get(), _PIN.get()

    @contextlib.contextmanager
    def restore():
        tok, tok2 = _SHARD.set(fn), _PIN.set(pin_fn)
        try:
            yield
        finally:
            _SHARD.reset(tok)
            _PIN.reset(tok2)

    return contextlib.nullcontext(), restore()
