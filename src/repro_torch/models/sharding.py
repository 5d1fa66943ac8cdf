"""Parameter/activation sharding rules for the production mesh (port of
``repro.models.sharding``).

Megatron-style tensor parallelism over the ``model`` axis plus FSDP
(ZeRO-3) over the flattened data axes (``("pod", "data")`` multi-pod,
``("data",)`` single-pod):

  * column-parallel weights (out-features feed per-head / per-channel
    compute): out dim → model, in dim → fsdp;
  * row-parallel weights (in-features are per-head): in dim → model,
    out dim → fsdp;
  * MoE expert tensors: expert dim → model (expert parallelism), d_model
    dim → fsdp;
  * embedding (V, d): vocab → model, d → fsdp; untied head (d, V):
    d → fsdp, V → model (logits arrive vocab-sharded — loss reductions
    become the model-axis collectives in the roofline);
  * 1-D scales/biases and small tables: replicated.

Every rule is divisibility-checked against the actual mesh: a dim that
does not divide its assigned axes falls back to replication for that dim
(e.g. hubert's 504-way vocab head on the reference's 16-way model
axis; the H100 mesh's 8-way axis divides it).

A spec is the reference's ``PartitionSpec`` as a tuple: one entry per
tensor dim, each ``None``, an axis name or a tuple of axis names. The
reference stacks a period member's layers on a leading scan-group axis,
which it never shards; the port's layers are unstacked, so its specs have
no leading ``None``. A mesh is a torch ``DeviceMesh`` or, for the rules
alone, a dict of axis sizes (``{"data": 16, "model": 16}``).

On a ``DeviceMesh`` a spec becomes DTensor placements (``placements``): a
tensor dim over (pod, data) is ``Shard(d)`` on both mesh dims, pod the
outer, as ``("pod", "data")`` orders a JAX mesh. ``make_act_sharder``
gives the hooks of ``models/shardctx.py``: the reference's activation
constraints, and the strategies of the regions DTensor has none for, each
computed on the shards with the placements GSPMD infers for it.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.distributed._functional_collectives as funcol
from torch import nn
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map

# leaf name → (kind) where kind picks the rule
_COL = {"q", "k", "v", "up", "gate", "r", "g", "q_a", "q_b", "kv_a", "k_b",
        "v_b", "x_proj", "dt_proj", "w_a", "in_proj"}
_ROW = {"o", "down", "out_proj", "w_b"}
_REPL = {"router", "mix", "u", "conv_b", "dt_bias"}


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name → size of a ``DeviceMesh`` (or of a dict of sizes)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes_size(shape: dict[str, int], axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return shape[axes]
    return math.prod(shape[a] for a in axes)


def _fit(spec: tuple, shape, sizes: dict[str, int]) -> tuple:
    """Drop any axis assignment whose size does not divide the dim."""
    fixed = []
    for dim, axes in zip(shape, spec):
        if isinstance(axes, tuple) and len(axes) == 1:
            axes = axes[0]          # canonical singleton form
        fixed.append(axes if dim % _axes_size(sizes, axes) == 0 else None)
    return tuple(fixed)


def _dp(sizes: dict[str, int], model: str):
    """The data axes: one name, or a tuple of them (multi-pod)."""
    dp = tuple(a for a in sizes if a != model)
    return dp[0] if len(dp) == 1 else dp


def _leaf_spec(name: str, shape, fsdp, model: str,
               sizes: dict[str, int]) -> tuple:
    keys = [k for k in name.split(".") if not k.isdigit()]
    leaf = keys[-1]
    in_layers = keys[0] == "layers"
    nd = len(shape)

    def fit(*spec):
        return _fit(spec, shape, sizes)

    if leaf == "embed":
        return fit(model, fsdp)
    if leaf == "head":
        return fit(fsdp, model)
    if leaf == "in_proj" and not in_layers:     # stub frontend projection
        return fit(None, model)
    # MoE expert tensors: (E, d, f) / (E, f, d) — expert dim first
    if leaf in ("gate", "up") and nd == 3:
        return fit(model, fsdp, None)
    if leaf == "down" and nd == 3:
        return fit(model, None, fsdp)
    if leaf in _REPL or any(k in _REPL for k in keys):
        return fit(*([None] * nd))
    if leaf in _COL and nd == 2:
        return fit(fsdp, model)
    if leaf in _ROW and nd == 2:
        return fit(model, fsdp)
    if leaf == "conv" and nd == 2:              # mamba depthwise conv
        return fit(None, model)
    if leaf == "A_log" and nd == 2:
        return fit(model, None)
    if leaf in ("D", "dt_bias") and nd == 1:
        return fit(model)
    return fit(*([None] * nd))                   # norms & leftovers


def _named_shapes(params):
    """(name, shape) pairs of a ``Model`` or of a ``ModelConfig`` (nothing
    allocated)."""
    from repro_torch.models import model as M
    if isinstance(params, M.ModelConfig):
        return M._shapes(params)
    return [(n, tuple(t.shape)) for n, t in params.named_parameters()]


def param_specs(params, mesh, *, fsdp=None, model: str = "model") -> dict:
    """Parameter name → spec (see the module docstring)."""
    sizes = mesh_shape(mesh)
    if fsdp is None:
        fsdp = _dp(sizes, model)
    return {n: _leaf_spec(n, s, fsdp, model, sizes)
            for n, s in _named_shapes(params)}


def placements(spec: tuple, mesh) -> tuple:
    """A spec as the DTensor placements of ``mesh``'s dims."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        for a in (axes,) if isinstance(axes, str) else axes:
            out[names.index(a)] = Shard(d)
    return tuple(out)


def param_placements(params, mesh, **kw) -> dict:
    """Parameter name → DTensor placements on ``mesh``."""
    return {n: placements(s, mesh)
            for n, s in param_specs(params, mesh, **kw).items()}


def _local_shape(shape, pl, mesh) -> tuple:
    out = list(shape)
    for p, n in zip(pl, mesh.shape):
        if isinstance(p, Shard):
            out[p.dim] //= n
    return tuple(out)


def _global_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def place(t: torch.Tensor, mesh, pl) -> DTensor:
    """``t`` laid out as ``pl`` on ``mesh``: a DTensor redistributed; a
    tensor on the ``meta`` device (or a fake stand-in) replaced by an empty
    shard of its own on ``t``'s device (``meta``: ``device``)."""
    if isinstance(t, DTensor):
        return t.redistribute(mesh, pl)
    local = torch.empty(_local_shape(t.shape, pl, mesh), dtype=t.dtype,
                        device=t.device)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=t.shape, stride=_global_stride(t.shape))


def distribute_model(model: nn.Module, mesh, *, device=None,
                     placements_of: dict | None = None) -> dict:
    """Replace every parameter of ``model`` by a DTensor parameter placed by
    the rules (or ``placements_of``) → name → placements. A parameter that
    holds data (the same on every rank, from one seed) keeps this rank's
    shard of it; one on the ``meta`` device (the dry run) becomes an empty
    shard on ``device``, a fake tensor under ``FakeTensorMode``."""
    pls = placements_of or param_placements(model, mesh)
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        pl = pls[name]
        if p.device.type == "meta":
            d = place(torch.empty(p.shape, dtype=p.dtype, device=device),
                      mesh, pl)
        else:
            d = distribute_tensor(p.detach(), mesh, pl, src_data_rank=None)
        setattr(mod, leaf, nn.Parameter(d, requires_grad=p.requires_grad))
    return pls


def batch_spec(mesh, ndim: int, *, model: str = "model") -> tuple:
    """Shard the leading (batch) dim over every non-model axis."""
    return (_dp(mesh_shape(mesh), model),) + (None,) * (ndim - 1)


def batch_sharding_for(mesh, leaf, *, model: str = "model") -> tuple:
    """Like batch_spec but divisibility-checked against the leaf's shape
    (batch=1 long-context cells fall back to replication)."""
    sizes = mesh_shape(mesh)
    spec = (_dp(sizes, model),) + (None,) * (len(leaf.shape) - 1)
    return _fit(spec, leaf.shape, sizes)


def shard_batch(x: torch.Tensor, mesh, *, model: str = "model") -> DTensor:
    """A batch leaf (the same on every rank) as a DTensor sharded by
    ``batch_sharding_for``: each rank keeps its rows, nothing is sent."""
    pl = placements(batch_sharding_for(mesh, x, model=model), mesh)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, pl)
    return distribute_tensor(x, mesh, pl, src_data_rank=None)


class _Unsharded:
    """A block whose calls run on its parameters gathered over the data
    axes (FSDP's unshard); autograd takes each gathered weight's grad back
    to its shard (a reduce-scatter)."""

    def __init__(self, blk: nn.Module, gather):
        self.blk, self.gather = blk, gather

    def _call(self, fn, *a, **kw):
        from torch.nn.utils.stateless import _reparametrize_module
        params = {n: self.gather(p) for n, p in self.blk.named_parameters()}
        with _reparametrize_module(self.blk, params):
            return fn(*a, **kw)

    def __call__(self, *a, **kw):
        return self._call(self.blk, *a, **kw)

    def prefill(self, *a, **kw):
        return self._call(self.blk.prefill, *a, **kw)

    def decode(self, *a, **kw):
        return self._call(self.blk.decode, *a, **kw)


def make_param_pinner(mesh, *, model: str = "model"):
    """``pin(blocks)`` → the blocks, each of whose calls gathers its
    parameters over the data axes first (tensor-parallel sharding kept)
    and drops them after, so a layer group's FSDP all-gather happens at
    the group, per iteration, and again in its recompute: the reference
    pins each group's parameter slices inside its scan body for the same
    end. Left to DTensor, each product picks its operands' layouts by
    cost and may gather a whole micro-batch's activations over the data
    axes instead of a weight's shards."""
    dp = [i for i, a in enumerate(mesh.mesh_dim_names) if a != model]

    def gather(p):
        if not isinstance(p, DTensor):
            return p
        pl = tuple(Replicate() if i in dp else q
                   for i, q in enumerate(p.placements))
        return p if pl == tuple(p.placements) else p.redistribute(mesh, pl)

    def pin(blocks):
        return [_Unsharded(b, gather) for b in blocks]

    return pin


def cache_specs(caches, mesh, *, batch: int, model: str = "model") -> list:
    """Decode-cache specs, one dict a layer: batch over data axes when it
    divides; otherwise (long-context, batch=1) the sequence/cache axis over
    data×model so a 500k KV cache fits a card (flash-decode layout).
    ``caches`` is ``model.init_caches``' list of dicts of tensors.
    """
    sizes = mesh_shape(mesh)
    dp = tuple(a for a in sizes if a != model)
    dp_size = math.prod(sizes[a] for a in dp)
    dpn = dp[0] if len(dp) == 1 else dp
    seq_axes = dp + (model,)

    def spec(name, shape) -> tuple:
        nd = len(shape)
        if batch % dp_size == 0 and batch > 1:
            if name in ("k", "v"):      # (B,S,K,hd): B→data, S→model
                s = (dpn, model) + (None,) * (nd - 2)
            elif name == "lat":         # (B,S,r): B→data, S→model
                s = (dpn, model, None)
            else:                        # pos/recurrent states: B→data
                s = (dpn,) + (None,) * (nd - 1)
        else:                            # batch too small: shard sequence
            if name in ("k", "v", "lat"):
                s = (None, seq_axes) + (None,) * (nd - 2)
            elif name == "pos":
                s = (None, seq_axes)
            else:
                s = (None,) * nd
        return _fit(s, shape, sizes)

    return [{n: spec(n, tuple(t.shape)) for n, t in c.items()}
            for c in caches]


# ---------------------------------------------------------------------------
# the activation sharder
# ---------------------------------------------------------------------------

def _is_shard(p, dim: int | None = None) -> bool:
    return isinstance(p, Shard) and (dim is None or p.dim == dim)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the grad contiguous: a region's
    local grads leave it wrapped as DTensors, which take a local tensor's
    layout for the global one's and cannot view a transposed shard."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


class _Pin(torch.autograd.Function):
    """x redistributed to ``pl``; its grad resolved to x's own layout, a
    partial sum there replicated (Megatron's backward: the grad of a
    row-parallel output is all-reduced, or all-gathered along a sequence
    it was scattered over), where DTensor would carry the grad on as a
    partial sum and then replicate the products that read it."""

    @staticmethod
    def forward(ctx, x, mesh, pl):
        ctx.mesh = mesh
        ctx.back = tuple(Replicate() if p.is_partial() else p
                         for p in x.placements)
        return x.redistribute(mesh, pl)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.back:
            g = g.redistribute(ctx.mesh, ctx.back)
        return g, None, None


class ActSharder:
    """The hooks of ``models/shardctx.py`` on ``mesh``.

    ``shard``/``view`` pin the tagged activations (the reference's
    ``make_act_sharder``):
      hidden (..., S, d): batch → data axes; with ``seq_parallel`` also
        S → model (Korthikanti-style sequence parallelism);
      block_in (..., S, d): batch → data axes (a sequence-parallel hidden
        state gathered before a block's products);
      logits (..., S, V): batch → data, V → model (vocab-parallel loss);
      cols (..., S, F): batch → data, F → model (a column-parallel
        product's output, kept so before its columns are split up);
      qkv (B, S, H|K, hd): batch → data, heads → model.
    Dims that don't divide fall back to replication (long_500k's batch=1).

    ``local(tag, fn, *args)`` runs the regions DTensor has no strategy
    for on the shards (``local_map``), with the placements GSPMD infers:
      attend: batch- and head-parallel attention; q's heads on the model
        axis, the kv heads too when they divide it, else each rank takes
        the kv heads its q heads read;
      decode_attend: flash-decoding over a sequence-sharded cache (partial
        max, sum and accumulator per shard, combined by all-reduces);
      cache_write: each lane's new row written by the shard that holds
        its slot;
      prefill_cache: a prefill's caches (padded, or a windowed layer's
        ring), batch- and head-parallel;
      moe_dispatch: routing over the micro-batch's gathered tokens; each
        rank keeps its slice of the dispatch buffer, its model rank's
        experts and its data rank's capacity slots (always: the expert
        products run on that layout, so the reference's ``moe_eb`` and
        ``moe_out`` pins and their ``moe_ep`` switch have no job here);
      moe_combine: each rank's slots' outputs weighted back onto the
        tokens, a partial sum over the mesh (the caller's hidden pin
        reduces it);
      dot_f32: the f32-output product of ``layers._MmF32``, rows as x's,
        columns as w's;
      xent: vocab-parallel cross-entropy (max, sum and the target's logit
        reduced over the model axis);
      embed: vocab-parallel lookup (a masked gather summed over the model
        axis), the table's FSDP dim gathered first;
      rwkv, mamba: the recurrences, batch- and head/channel-parallel.
    A parameter replicated on an axis its region's work is split over
    gets its grad as a partial sum there.
    """

    def __init__(self, mesh, *, model: str = "model",
                 seq_parallel: bool = False):
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.sizes = mesh_shape(mesh)
        self.model = model
        self.m = self.names.index(model)
        self.dp = tuple(i for i, a in enumerate(self.names) if a != model)
        self.dpn = _dp(self.sizes, model)
        self.seq_parallel = seq_parallel
        self.coord = mesh.get_coordinate()
        self._rules = dict(
            attend=self._attend, decode_attend=self._decode_attend,
            cache_write=self._cache_write, prefill_cache=self._prefill_cache,
            moe_dispatch=self._moe_dispatch, moe_combine=self._moe_combine,
            dot_f32=self._dot_f32, xent=self._xent, embed=self._embed,
            rwkv=self._rwkv, mamba=self._mamba)

    # -- shard / view ------------------------------------------------------

    def spec(self, shape, tag: str) -> tuple:
        """The tag's spec for a tensor of ``shape``."""
        nd, dp, model = len(shape), self.dpn, self.model
        if tag in ("logits", "cols"):
            spec = (dp,) + (None,) * (nd - 2) + (model,)
        elif tag == "qkv":
            spec = (dp, None, model, None)
        elif tag == "hidden" and self.seq_parallel and nd >= 3:
            spec = (dp, model) + (None,) * (nd - 2)
        else:
            spec = (dp,) + (None,) * (nd - 1)
        return _fit(spec, shape, self.sizes)

    def __call__(self, x, tag: str):
        if not isinstance(x, DTensor):
            return x
        pl = placements(self.spec(x.shape, tag), self.mesh)
        return _Pin.apply(x, self.mesh, pl)

    def view(self, x, shape, tag: str):
        """x reshaped to ``shape`` (its last dim split in two) and pinned: a
        sharding of x's last dim that the tag does not keep on the new
        leading dim is gathered first."""
        if not isinstance(x, DTensor):
            return x.reshape(shape)
        want = placements(self.spec(shape, tag), self.mesh)
        split = len(shape) - 2
        pre = tuple(Replicate() if _is_shard(p, x.ndim - 1)
                    and not _is_shard(want[i], split) else p
                    for i, p in enumerate(x.placements))
        if pre != tuple(x.placements):
            x = x.redistribute(self.mesh, pre)
        return self(x.reshape(shape), tag)

    # -- regions -----------------------------------------------------------

    def local(self, tag: str, fn, *args, **kw):
        if not any(isinstance(a, DTensor) for a in args):
            return fn(*args, **kw)
        if tag not in self._rules:
            raise NotImplementedError(f"no sharding strategy for region "
                                      f"{tag!r} ({getattr(fn, '__name__', fn)})")
        return self._rules[tag](fn, *args, **kw)

    def _run(self, fn, args, in_pl, out_pl, grad_pl=None, kw=None):
        """``fn`` on the local shards of ``args`` (redistributed to
        ``in_pl``); ``out_pl``: one output's placements, or a tuple of
        them for a tuple of outputs."""
        f0 = functools.partial(fn, **kw) if kw else fn
        rep = (Replicate(),) * len(self.names)
        # a plain tensor made inside the model (a zero state) is the same on
        # every rank: replicated, then laid out as asked
        args = tuple(DTensor.from_local(a, self.mesh, rep, run_check=False)
                     if isinstance(a, torch.Tensor) and not isinstance(
                         a, DTensor) and pl is not None else a
                     for a, pl in zip(args, in_pl))

        def f(*local):
            return f0(*[_ContiguousGrad.apply(t) if isinstance(
                t, torch.Tensor) and t.requires_grad else t for t in local])

        if out_pl and not isinstance(out_pl[0], tuple):
            out_pl = list(out_pl)
        if not torch.is_grad_enabled():
            grad_pl = None
        return local_map(f, out_placements=out_pl,
                         in_placements=tuple(in_pl),
                         in_grad_placements=None if grad_pl is None
                         else tuple(grad_pl),
                         device_mesh=self.mesh, redistribute_inputs=True)(*args)

    def _pl(self, t):
        """t's placements, a pending partial sum resolved (replicated)."""
        if not isinstance(t, DTensor):
            return None
        return tuple(Replicate() if p.is_partial() else p
                     for p in t.placements)

    def _batch(self, t, dim: int = 0) -> list:
        """Placements with t's sharding of ``dim`` on the data dims, the
        rest replicated."""
        pl = [Replicate()] * len(self.names)
        if isinstance(t, DTensor):
            for i in self.dp:
                if _is_shard(t.placements[i], dim):
                    pl[i] = Shard(dim)
        return pl

    def _grads(self, in_pl: list, work: list) -> list:
        """Grad placements: Partial on the mesh dims where the work is split
        (``work``: placements of the region's widest input) and the input
        is replicated."""
        out = []
        for pl in in_pl:
            if pl is None:
                out.append(None)
                continue
            out.append(tuple(Partial() if isinstance(p, Replicate)
                             and isinstance(w, Shard) else p
                             for p, w in zip(pl, work)))
        return out

    def _linear(self, dims) -> int:
        """This rank's linear index over mesh dims ``dims`` (outer first)."""
        idx = 0
        for i in dims:
            idx = idx * self.mesh.shape[i] + self.coord[i]
        return idx

    def _prefill_cache(self, fn, *args, **kw):
        """Batch- and head-parallel: each output laid out as its input
        (positions by batch only)."""
        in_pl = [tuple(self._batch(a)) if a.dtype in (torch.int32, torch.int64)
                 else self._pl(a) for a in args]
        return self._run(fn, args, in_pl, tuple(in_pl),
                         self._grads(in_pl, list(in_pl[0])), kw)

    def _attend(self, fn, q, k, v, qpos, kvpos, **kw):
        H, K = q.shape[2], k.shape[2]
        msz = self.mesh.shape[self.m]
        bat = self._batch(q)
        qh, kh, sl = Replicate(), Replicate(), False
        if H % msz == 0:
            Hl, G = H // msz, H // K
            if K % msz == 0:
                qh = kh = Shard(2)
            elif Hl % G == 0 or G % Hl == 0:
                qh, sl = Shard(2), True
        q_pl = tuple(qh if i == self.m else p for i, p in enumerate(bat))
        k_pl = tuple(kh if i == self.m else p for i, p in enumerate(bat))
        pos_pl = tuple(bat)
        r = self.coord[self.m]

        def body(q, k, v, qp, kp):
            if sl:                      # this rank's q heads' kv heads
                Hl = q.shape[2]
                G = H // K
                k0, nk = r * Hl // G, max(Hl // G, 1)
                k, v = k[:, :, k0:k0 + nk], v[:, :, k0:k0 + nk]
            return fn(q, k, v, qp, kp, **kw)

        in_pl = [q_pl, k_pl, k_pl, pos_pl, pos_pl]
        return self._run(body, (q, k, v, qpos, kvpos), in_pl, q_pl,
                         self._grads(in_pl, list(q_pl)))

    def _seq_dims(self, cache) -> tuple:
        return tuple(i for i, p in enumerate(cache.placements)
                     if _is_shard(p, 1))

    def _cache_write(self, fn, cache, slot, value, *, lanes):
        # ``lanes`` indexes the whole batch: each shard indexes its own
        c_pl = tuple(cache.placements)
        sdims = self._seq_dims(cache)
        bat = self._batch(cache)
        v_pl = tuple(bat)
        off = self._linear(sdims) if sdims else None

        def body(c, s, val):
            bidx = torch.arange(c.shape[0], device=c.device)
            if off is None:
                return fn(c, s, val, lanes=bidx)
            Wl = c.shape[1]
            ls = s - off * Wl
            ok = (ls >= 0) & (ls < Wl)
            ls = ls.clamp(0, Wl - 1)
            cur = c[bidx, ls]
            okb = ok.reshape(ok.shape + (1,) * (cur.dim() - 1))
            c[bidx, ls] = torch.where(okb, val.to(c.dtype), cur)
            return c

        return self._run(body, (cache, slot, value), [c_pl, v_pl, v_pl],
                         c_pl)

    def _decode_attend(self, fn, q, k, v, qpos, kvpos, *, window=None,
                       softcap=None, scale=None):
        from repro_torch.models.attention import _NEG, _softcap
        sdims = self._seq_dims(k)
        bat = self._batch(k)
        q_pl = tuple(bat)
        kv_pl = tuple(Shard(1) if i in sdims else p for i, p in enumerate(bat))
        kw = dict(window=window, softcap=softcap, scale=scale)
        if not sdims:
            return self._run(fn, (q, k, v, qpos, kvpos),
                             [q_pl, kv_pl, kv_pl, q_pl, kv_pl], q_pl, kw=kw)
        mesh = self.mesh

        def body(q, k, v, qp, kp):
            B, Sq, H, hd = q.shape
            K, hd_v = k.shape[2], v.shape[-1]
            G = H // K
            sc = scale if scale is not None else hd ** -0.5
            qf = q.reshape(B, Sq, K, G, hd).float() * sc
            logits = _softcap(torch.einsum("bqkgh,bskh->bkgqs", qf,
                                           k.float()), softcap)
            kpp, qpp = kp[:, None, :], qp[:, :, None]
            mask = (kpp >= 0) & (kpp <= qpp)
            if window is not None:
                mask = mask & (kpp > qpp - window)
            logits = torch.where(mask[:, None, None], logits, _NEG)
            m = logits.amax(-1)
            for i in sdims:
                m = funcol.all_reduce(m, "max", (mesh, i))
            p = torch.exp(logits - m[..., None])
            stats = torch.cat([p.sum(-1)[..., None],
                               torch.einsum("bkgqs,bskh->bkgqh", p,
                                            v.float())], -1)
            for i in sdims:
                stats = funcol.all_reduce(stats, "sum", (mesh, i))
            out = stats[..., 1:] / stats[..., :1]
            return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd_v
                                                      ).to(q.dtype)

        return self._run(body, (q, k, v, qpos, kvpos),
                         [q_pl, kv_pl, kv_pl, q_pl, kv_pl], q_pl)

    def _moe_layout(self, E: int, cap: int):
        """The dispatch buffer (E, cap, d)'s placements: experts over the
        model axis, capacity slots over the data axes, where they divide
        (no rank repeats another's expert products) → (placements,
        expert-sharded, slot-sharded)."""
        ep = E % self.mesh.shape[self.m] == 0
        dps = math.prod(self.mesh.shape[i] for i in self.dp)
        cp = cap % dps == 0
        pl = tuple(Shard(0) if i == self.m and ep else
                   Shard(1) if i in self.dp and cp else Replicate()
                   for i in range(len(self.names)))
        return pl, ep, cp

    def _moe_dispatch(self, fn, xt, probs, *, k: int, cap: int):
        E = probs.shape[-1]
        rep = (Replicate(),) * len(self.names)
        eb_pl, ep, cp = self._moe_layout(E, cap)
        re, rc = self.coord[self.m], self._linear(self.dp)

        def body(xt, probs):
            eb, *route = fn(xt, probs, k=k, cap=cap)
            if ep:
                El = E // self.mesh.shape[self.m]
                eb = eb[re * El:(re + 1) * El]
            if cp:
                cl = cap // math.prod(self.mesh.shape[i] for i in self.dp)
                eb = eb[:, rc * cl:(rc + 1) * cl]
            return (eb, *route)

        # each rank's tokens' grad covers only its buffer slice
        x_grad = tuple(Partial() if isinstance(p, Shard) else Replicate()
                       for p in eb_pl)
        return self._run(body, (xt, probs), [rep, rep],
                         (eb_pl, rep, rep, rep, rep), [x_grad, rep])

    def _moe_combine(self, fn, out_e, slot, s_tok, s_w, keep, *, T: int):
        rep = (Replicate(),) * len(self.names)
        e_pl = tuple(out_e.placements)
        ep = _is_shard(e_pl[self.m], 0)
        cp = any(_is_shard(e_pl[i], 1) for i in self.dp)
        re, rc = self.coord[self.m], self._linear(self.dp)
        E, cap = out_e.shape[0], out_e.shape[1]

        def body(out_e, slot, s_tok, s_w, keep):
            El, cl = out_e.shape[0], out_e.shape[1]
            if ep or cp:                 # this rank's slice of the slots
                e, c = slot // cap, slot % cap
                le = e - re * El if ep else e
                lc = c - rc * cl if cp else c
                ok = (keep & (slot < E * cap) & (le >= 0) & (le < El)
                      & (lc >= 0) & (lc < cl))
                slot, keep = torch.where(ok, le * cl + lc, El * cl), ok
            return fn(out_e, slot, s_tok, s_w, keep, T=T)

        part = tuple(Partial() if isinstance(p, Shard) else Replicate()
                     for p in e_pl)
        return self._run(body, (out_e, slot, s_tok, s_w, keep),
                         [e_pl, rep, rep, rep, rep], part,
                         [e_pl, rep, rep, part, rep])

    def _dot_f32(self, fn, x, w):
        x_pl = tuple(Shard(0) if i in self.dp and _is_shard(p, 0)
                     else Replicate() for i, p in enumerate(x.placements))
        w_pl = tuple(Shard(1) if _is_shard(p, 1) else Replicate()
                     for p in w.placements)
        out = tuple(a if isinstance(a, Shard) else b if isinstance(
            b, Shard) else Replicate() for a, b in zip(x_pl, w_pl))
        xg = tuple(Partial() if isinstance(b, Shard) else a
                   for a, b in zip(x_pl, w_pl))
        wg = tuple(Partial() if isinstance(a, Shard) else b
                   for a, b in zip(x_pl, w_pl))
        return self._run(fn, (x, w), [x_pl, w_pl], out, [xg, wg])

    def _xent(self, fn, logits, targets):
        if not _is_shard(logits.placements[self.m], logits.ndim - 1):
            return fn(logits, targets)
        valid = targets >= 0
        tgt = torch.where(valid, targets, 0).long()
        # every reduction over the model axis resolved in place, to the
        # batch layout (DTensor would scatter a partial sum by cost)
        m = logits.detach().amax(-1, keepdim=True)
        m = m.redistribute(self.mesh, self._batch(m))
        se = torch.exp(logits - m).sum(-1)
        se = se.redistribute(self.mesh, self._batch(se))
        logz = torch.log(se) + m[..., 0]
        lg_pl = tuple(logits.placements)
        t_pl = tuple(self._batch(tgt))
        part = tuple(Partial() if i == self.m else p
                     for i, p in enumerate(t_pl))
        r = self.coord[self.m]

        def gold(lg, t):                # the target's logit where it lives
            Vl = lg.shape[-1]
            lt = t - r * Vl
            ok = (lt >= 0) & (lt < Vl)
            g = lg.gather(-1, lt.clamp(0, Vl - 1)[..., None])[..., 0]
            return torch.where(ok, g, 0.0)

        g = self._run(gold, (logits, tgt), [lg_pl, t_pl], part, [lg_pl, t_pl])
        g = g.redistribute(self.mesh, t_pl)
        return torch.where(valid, logz - g, 0.0)

    def _embed(self, fn, table, ids):
        if not _is_shard(table.placements[self.m], 0):
            return fn(table, ids)
        t_pl = tuple(Shard(0) if i == self.m else Replicate()
                     for i in range(len(self.names)))
        i_pl = tuple(self._batch(ids))
        out = tuple(Partial() if i == self.m else p
                    for i, p in enumerate(i_pl))
        r = self.coord[self.m]

        def lookup(tab, ids):           # the rows this rank's vocab holds
            Vl = tab.shape[0]
            li = ids.long() - r * Vl
            ok = (li >= 0) & (li < Vl)
            rows = fn(tab, li.clamp(0, Vl - 1))
            return torch.where(ok[..., None], rows, 0)

        return self._run(lookup, (table, ids), [t_pl, i_pl], out,
                         self._grads([t_pl, i_pl], list(i_pl)))

    def _rwkv(self, fn, r, k, v, logw, u, s, *, Q: int):
        x_pl = self._pl(r)
        heads = _is_shard(x_pl[self.m], 1)
        u_pl = tuple(Shard(0) if i == self.m and heads else Replicate()
                     for i in range(len(self.names)))
        s_pl = tuple(Shard(0) if i in self.dp and _is_shard(p, 0)
                     else Shard(1) if i == self.m and heads else Replicate()
                     for i, p in enumerate(x_pl))
        in_pl = [x_pl, x_pl, x_pl, x_pl, u_pl, s_pl]
        return self._run(fn, (r, k, v, logw, u, s), in_pl, (x_pl, s_pl),
                         self._grads(in_pl, list(x_pl)), dict(Q=Q))

    def _mamba(self, fn, h, dt, B_in, C_in, xin, A):
        x_pl = self._pl(dt)
        ch = _is_shard(x_pl[self.m], 2)
        bat = self._batch(dt)
        n_pl = tuple(bat)
        h_pl = tuple(Shard(1) if i == self.m and ch else p
                     for i, p in enumerate(bat))
        a_pl = tuple(Shard(0) if i == self.m and ch else Replicate()
                     for i in range(len(self.names)))
        in_pl = [h_pl, x_pl, n_pl, n_pl, x_pl, a_pl]
        return self._run(fn, (h, dt, B_in, C_in, xin, A), in_pl,
                         (h_pl, x_pl), self._grads(in_pl, list(x_pl)))


def make_act_sharder(mesh, *, model: str = "model", seq_parallel: bool = False
                     ) -> ActSharder:
    """The sharder ``model.activation_sharding`` installs (see
    ``ActSharder``)."""
    return ActSharder(mesh, model=model, seq_parallel=seq_parallel)
