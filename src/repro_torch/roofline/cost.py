"""One rank's cost of a step, counted op by op (the port's counterpart of
``repro.roofline.hlo_cost``).

The reference walks the compiled, SPMD-partitioned HLO of one device,
scaling scan bodies by their trip counts. The port runs the step eagerly
(on fake tensors in the dry run), so every iteration is an op of its own
and no trip-count scaling is needed. ``CostCounter`` is a
``TorchDispatchMode`` that sits **below DTensor**: it declines DTensor
ops (``NotImplemented``), so DTensor dispatches them and the counter sees
the local ops on this rank's shards, its collectives among them. Ops that
DTensor runs on global shapes only to infer its outputs' metadata are not
counted.

  * **flops** — every product (``mm`` with or without an f32 output,
    ``addmm``, ``bmm``, ``baddbmm``; ``matmul`` and ``einsum`` reach these):
    2·∏result·∏contracting;
  * **bytes** — Σ (operand + result bytes) of every op but views and
    metadata (in eager torch every op is a kernel: the counterpart of the
    reference's top-level ops after fusion);
  * **bytes_min** — each distinct storage read once, each result written
    once;
  * **collectives** — every ``_c10d_functional`` op with its group size
    and bytes (``analysis.CollectiveRecord``), priced by the reference's
    ring factors;
  * **peak_bytes** — the peak of the bytes held by live storages: the
    tensors given to ``track`` (parameters, optimizer state, batch) plus
    every op's results until they are freed, each rounded up to the CUDA
    caching allocator's 512-byte blocks.

The port's own ops (``repro_torch::*`` custom ops, ``PRICED``) are
priced as a whole, since the counter sees them as one op: the f32/bf16
gather distance (#3) analytically, as the reference counts
``ref.rowwise_sq_dists`` (subtract, square, reduce: 3·B·K·d FLOPs; its
rows, queries, ids and output read or written once), and the Mamba scan
and its backward by the counter's own count of their loop over 1 and 2
tokens, extended to the S tokens as exact repeats (as ``trace_cost``
extends a few layer groups to all). ``max_ops`` bounds the ops dispatched, a priced op being
one.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.roofline.analysis import CollectiveRecord

aten = torch.ops.aten

_MM = {aten.mm.default, aten.mm.dtype}
_ADDMM = {aten.addmm.default}
_BMM = {aten.bmm.default, aten.bmm.dtype}
_BADDBMM = {aten.baddbmm.default}
# ops that move no data: metadata queries, allocation without a write
_NO_BYTES = {aten.empty.memory_format, aten.empty_strided.default,
             aten.new_empty.default, aten.new_empty_strided.default,
             aten.empty_like.default, aten.detach.default,
             aten.alias.default, aten._local_scalar_dense.default,
             aten.lift_fresh.default, aten.sym_size.int,
             aten.sym_stride.int, aten.sym_numel.default,
             aten.sym_storage_offset.default, aten.is_same_size.default}
# metadata queries: not ops (FakeTensorMode asks each tensor's device)
_QUERIES = {torch.ops.prim.device.default, torch.ops.prim.layout.default}
# a ``torch.profiler.record_function`` span's ends
_SPAN_ENTER = torch.ops.profiler._record_function_enter_new.default
_SPAN_EXIT = torch.ops.profiler._record_function_exit._RecordFunction
_KIND = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
         "all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all", "broadcast": "all-gather",
         "broadcast_": "all-gather", "permute_tensor": "collective-permute"}

# > 0 while DTensor infers an op's output metadata on global shapes
_SUSPENDED = [0]
_PATCHED = [0, None]


def _suspend_prop():
    """Mark DTensor's shape inference so the counter skips its ops."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    if _PATCHED[0] == 0:
        orig = ShardingPropagator._propagate_tensor_meta_non_cached

        def wrapped(self, op_schema):
            _SUSPENDED[0] += 1
            try:
                return orig(self, op_schema)
            finally:
                _SUSPENDED[0] -= 1

        _PATCHED[1] = orig
        ShardingPropagator._propagate_tensor_meta_non_cached = wrapped
    _PATCHED[0] += 1


def _restore_prop():
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    _PATCHED[0] -= 1
    if _PATCHED[0] == 0:
        ShardingPropagator._propagate_tensor_meta_non_cached = _PATCHED[1]


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _args_tensors(args, kwargs) -> list:
    """The tensors among an op's arguments (also inside lists: ``cat``)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _out_tensors(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for t in out if isinstance(t, torch.Tensor)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _block(n: int) -> int:
    return -(-n // 512) * 512


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = next((a for a in reversed(args) if isinstance(a, str)), None)
    return _resolve_process_group(name).size() if name is not None else 1


class DryRunBudgetExceeded(RuntimeError):
    pass


@dataclasses.dataclass
class Cost:
    """What a stretch of a step cost one rank: FLOPs, bytes, write-once
    bytes, local ops and its collectives (record → how many;
    ``analysis.collective_stats`` prices them). Costs add, subtract and
    scale, so the cost of a repeated stretch (a layer group, a
    micro-batch) can be taken once and multiplied, as the reference scales
    a scan body by its trip count."""
    flops: float = 0.0
    bytes: float = 0.0
    bytes_min: float = 0.0
    n_ops: int = 0
    coll: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def __add__(self, o: "Cost") -> "Cost":
        c = collections.Counter(self.coll)
        for k, v in o.coll.items():
            c[k] += v
        return Cost(self.flops + o.flops, self.bytes + o.bytes,
                    self.bytes_min + o.bytes_min, self.n_ops + o.n_ops, c)

    def __mul__(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.bytes * k, self.bytes_min * k,
                    self.n_ops * k,
                    collections.Counter({r: n * k for r, n in self.coll.items()}))

    def __sub__(self, o: "Cost") -> "Cost":
        return self + o * -1


def _price_gather(args) -> Cost:
    """#3, ``repro_torch::gather_sq_dists(vecs, x, idx)``: 3·B·K·d FLOPs;
    K·B rows and the B queries read in their dtype, the int32 ids read
    and the f32 output written once."""
    vecs, x, idx = args[:3]
    (B, K), d = idx.shape, x.shape[1]
    n = (B * K * d * vecs.element_size() + B * d * x.element_size()
         + 4 * B * K + 4 * B * K)
    return Cost(flops=3.0 * B * K * d, bytes=n, bytes_min=n, n_ops=1)


_LOOP_COSTS: dict = {}


def _default_keys():
    """The dispatcher's default thread-local key sets (include: backend
    select and in-place-or-view; exclude: autocast), built here rather
    than read: a read inside an op, a dispatch mode or ``inference_mode``
    would see autograd or the Python key excluded."""
    K, KS = torch._C.DispatchKey, torch._C.DispatchKeySet
    exclude = KS(K.Undefined)
    for name in K.__members__:
        if name.startswith("Autocast"):
            exclude = exclude | KS(getattr(K, name))
    return KS(K.BackendSelect) | KS(K.ADInplaceOrView), exclude


def _loop_price(fn_name: str, seq_args: tuple):
    """Price a ``models.ssm`` loop over dim 1 (the tokens) of the
    arguments at ``seq_args``: its ops counted on meta tensors of 1 and 2
    tokens, outside the op (the default dispatch keys, so autograd records
    and composite ops such as einsum decompose into the products the
    counter prices), and extended to S as exact repeats of the second
    token. That is exact for the scan and for its autograd backward: every
    token runs the same ops, and the inputs are split into tokens once."""
    def price(args) -> Cost:
        from repro_torch.models import ssm
        key = (fn_name,) + tuple(
            (tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor)
            else tuple(a) if isinstance(a, list) else a for a in args)
        if key not in _LOOP_COSTS:
            S = args[seq_args[0]].shape[1]

            def at(s: int) -> Cost:
                meta = [torch.empty(a.shape[:1] + (s,) + a.shape[2:]
                                    if i in seq_args else a.shape,
                                    dtype=a.dtype, device="meta")
                        if isinstance(a, torch.Tensor) else a
                        for i, a in enumerate(args)]
                cc = CostCounter()
                with torch._C._ForceDispatchKeyGuard(*_default_keys()), \
                        _disable_current_modes(), cc:
                    getattr(ssm, fn_name)(*meta)
                return cc.snapshot()

            c = [at(s) for s in range(1, min(S, 2) + 1)]
            _LOOP_COSTS[key] = c[0] if S == 1 else \
                c[0] + (c[1] - c[0]) * (S - 1)
        return _LOOP_COSTS[key]
    return price


# the port's custom ops the counter prices as a whole
PRICED = {
    "repro_torch::gather_sq_dists": _price_gather,
    "repro_torch::mamba_scan": _loop_price("_mamba_inner_scan", (1, 2, 3, 4)),
    "repro_torch::mamba_scan_backward": _loop_price("mamba_scan_grads",
                                                    (1, 2, 3, 4, 7)),
}


class CostCounter(TorchDispatchMode):
    """Counts one rank's local ops while it is entered (see the module
    docstring). ``max_ops``: raise ``DryRunBudgetExceeded``, naming the
    op dispatched most, once more local ops than that are dispatched.
    ``spans``: names of ``torch.profiler.record_function`` spans whose
    costs to keep: ``self.spans[name]`` lists each such span's cost (a
    training step's micro-batches, ``train.loop.MICROBATCH_SPAN``).
    ``n_dispatched`` counts the ops seen (a priced op once)."""

    def __init__(self, *, max_ops: int | None = None, spans=()):
        super().__init__()
        self.spans: dict[str, list[Cost]] = {n: [] for n in spans}
        self._open: list = []
        self.cost = Cost()
        self.op_counts: collections.Counter = collections.Counter()
        self.max_ops = max_ops
        self.n_dispatched = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live = WeakIdKeyDictionary()
        self._read = WeakIdKeyDictionary()

    # -- memory ------------------------------------------------------------

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def _hold(self, t: torch.Tensor) -> None:
        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        if st in self._live:
            return
        n = _block(st.nbytes())
        self._live[st] = n
        weakref.finalize(st, self._free, n)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def track(self, *trees) -> None:
        """Count the storages of the tensors in ``trees`` as held (they
        were made before the counter was entered)."""
        for tree in trees:
            for t in _tensors(tree):
                self._hold(t)

    # -- dispatch ----------------------------------------------------------

    def __enter__(self):
        _suspend_prop()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _restore_prop()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return func(*args, **kwargs)
        if func is _SPAN_ENTER:
            kept = args[0] in self.spans
            self._open.append((args[0], self.snapshot() if kept else None))
            return func(*args, **kwargs)
        if func is _SPAN_EXIT:
            # a span opened before the counter was entered is not its own
            name, start = self._open.pop() if self._open else (None, None)
            if start is not None:
                self.spans[name].append(self.snapshot() - start)
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _SUSPENDED[0]:
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        c = self.cost
        self.n_dispatched += 1
        self.op_counts[func] += 1
        if self.max_ops is not None and self.n_dispatched > self.max_ops:
            op, n = self.op_counts.most_common(1)[0]
            raise DryRunBudgetExceeded(
                f"more than {self.max_ops} local ops; {op} ran {n} times")
        ns = func.namespace
        price = PRICED.get(func._schema.name) if ns == "repro_torch" else None
        if price is not None:
            self.cost = c + price(args)
            for t in _out_tensors(out):
                self._hold(t)
            return
        c.n_ops += 1
        if ns in ("_c10d_functional", "_c10d_functional_autograd"):
            name = func._schema.name.split("::")[-1]
            if name not in _KIND:
                # wait_tensor, and _wrap_tensor_autograd on real tensors:
                # they move no bytes and hand back the collective's result
                return
            for t in _out_tensors(out):
                c.coll[CollectiveRecord(_KIND[name], _nbytes(t),
                                        _group_size(args))] += 1
        ins = _args_tensors(args, kwargs)
        res = _out_tensors(out)
        if func in _MM or func in _BMM:
            c.flops += 2.0 * res[0].numel() * ins[0].shape[-1]
        elif func in _ADDMM or func in _BADDBMM:
            c.flops += 2.0 * res[0].numel() * ins[1].shape[-1]
        if func in _NO_BYTES or func.is_view:
            return
        c.bytes += sum(_nbytes(t) for t in ins) + sum(
            _nbytes(t) for t in res)
        for t in ins:
            st = t.untyped_storage()
            if st not in self._read:
                self._read[st] = True
                c.bytes_min += st.nbytes()
        c.bytes_min += sum(_nbytes(t) for t in res)
        for t in res:
            self._hold(t)

    # -- results -----------------------------------------------------------

    def snapshot(self) -> Cost:
        """The cost so far (a copy)."""
        return self.cost + Cost()

    flops = property(lambda self: self.cost.flops)
    bytes = property(lambda self: self.cost.bytes)
    bytes_min = property(lambda self: self.cost.bytes_min)
    n_ops = property(lambda self: self.cost.n_ops)
