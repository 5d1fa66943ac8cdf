"""Layer primitives shared by the 10-arch zoo (port of ``repro.models.layers``).

Parameters keep the reference's ``(in, out)`` layout, so ``y = x @ w``,
and are drawn by a ``ParamInit`` (device and generator; the ``meta``
device allocates nothing). Every product accumulates in f32
(``core.types.resolve_device`` turns reduced-precision reductions off):
``torch.matmul`` rounds the f32 sum to the activation dtype, as the
reference's ``matmul`` (``preferred_element_type=f32``, then ``astype``)
does, and ``dot_f32`` returns the f32 sum itself.

JAX names: ``dense_init`` is ``ParamInit.dense``; ``matmul`` is
``torch.matmul``; ``mlp_init``/``mlp_apply`` are ``MLP``/``MLP.forward``;
``moe_init``/``moe_apply`` are ``MoE``/``MoE.forward``; ``moe_aux_loss``
takes the ``MoE`` itself. ``attn_init``/``attn_apply`` have no counterpart:
the blocks use ``blocks.GQA`` and ``attention.py``.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import shardctx


# ---------------------------------------------------------------------------
# initializers / common
# ---------------------------------------------------------------------------

class ParamInit:
    """Draws parameters on ``device`` from ``generator`` (a generator on
    that device). On the ``meta`` device nothing is drawn or allocated:
    that is how parameter counts are taken."""

    def __init__(self, device, generator: torch.Generator | None = None):
        self.device = torch.device(device)
        self.generator = generator

    def param(self, shape, dtype, fill) -> nn.Parameter:
        """A parameter of ``shape``: ``fill`` writes an f32 tensor in place,
        which is then cast to ``dtype``."""
        if self.device.type == "meta":
            t = torch.empty(shape, dtype=dtype, device=self.device)
        else:
            t = torch.empty(shape, dtype=torch.float32, device=self.device)
            fill(t)
            t = t.to(dtype)
        return nn.Parameter(t, requires_grad=False)

    def dense(self, shape, dtype, fan_in: int | None = None) -> nn.Parameter:
        """N(0, 1) truncated to [-2, 2], times 1/√fan_in (the reference's
        ``dense_init``), drawn in f32 and cast."""
        std = 1.0 / np.sqrt(fan_in if fan_in is not None else shape[0])
        lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
            (1 + math.erf(2 / math.sqrt(2))) / 2

        def fill(t):
            t.uniform_(lo, hi, generator=self.generator)
            t.mul_(2).sub_(1).erfinv_().mul_(math.sqrt(2)).clamp_(-2, 2)
            t.mul_(std)
        return self.param(shape, dtype, fill)

    def uniform(self, shape, dtype) -> nn.Parameter:
        return self.param(shape, dtype, lambda t: t.uniform_(
            0, 1, generator=self.generator))

    def normal(self, shape, dtype, mean: float, std: float) -> nn.Parameter:
        return self.param(shape, dtype, lambda t: t.normal_(
            mean, std, generator=self.generator))

    def const(self, value, dtype=torch.float32) -> nn.Parameter:
        value = torch.as_tensor(value, dtype=torch.float32)
        return self.param(tuple(value.shape), dtype,
                           lambda t: t.copy_(value))

    def zeros(self, shape, dtype=torch.float32) -> nn.Parameter:
        return self.param(shape, dtype, lambda t: t.zero_())


class _MmF32(torch.autograd.Function):
    """``torch.mm(x, w, out_dtype=f32)`` of 2-D bf16 operands with a
    backward: that op has no derivative. The cotangents are the
    reference's ``dot_general`` transposes: the f32 cotangent times the
    other operand (upcast, so the product is exact) summed in f32, then
    rounded to the operand's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.mm(g, w.t().float()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = torch.mm(x.t().float(), g).to(w.dtype)
        return gx, gw


def _mm_upcast(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.float(), w.float())


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (batched over leading axes) accumulated and returned in
    f32, not rounded to the operands' dtype. On the card a 2-D bf16
    product runs as one ``torch.mm`` with an f32 output (no f32 copy of
    ``w``: the tied 256,000-row table would be 3.7 GB), under autograd
    through ``_MmF32``; elsewhere the operands are upcast, which is exact
    (a bf16 product is exact in f32), and autograd's cotangents are the
    same as ``_MmF32``'s. A 2-D ``w``'s product is a sharding region
    (``shardctx.local``), laid out as its operands are."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        fn = torch.matmul
    elif x.is_cuda and w.dim() == 2:
        fn = _MmF32.apply
    else:
        fn = _mm_upcast
    if w.dim() != 2:
        return fn(x, w)
    return shardctx.local("dot_f32", fn, x.reshape(-1, x.shape[-1]), w
                          ).reshape(*x.shape[:-1], w.shape[-1])


def recompute(fn, *args):
    """``fn(*args)`` under autograd without keeping its intermediates: the
    backward pass runs ``fn`` again (``jax.checkpoint``'s remat;
    non-reentrant ``torch.utils.checkpoint``, which nests). The recompute
    runs under the sharding hooks of the forward (the backward of a CUDA
    tensor runs on another thread, which a context variable does not
    reach), and stashes no RNG state: the forward draws no random
    numbers."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=shardctx.checkpoint_contexts)


def call(fn, *args):
    """``fn(*args)``: ``recompute``'s stand-in where nothing is recomputed."""
    return fn(*args)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# rotary embeddings (RoPE + Qwen2-VL M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=64)
def _freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_freqs`` as an f32 tensor on ``device``, made once: a copy
    from the host each call would stall the card's queue twice a layer."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                           device=device)


@functools.lru_cache(maxsize=64)
def _section_ids(sections: tuple[int, ...], device: torch.device
                 ) -> torch.Tensor:
    """The M-RoPE section of each of the hd/2 frequency slots."""
    return torch.as_tensor(np.repeat(np.arange(len(sections)), sections),
                           device=device)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) int."""
    return _rotate(x, positions[..., None].float()
                   * _freqs(x.shape[-1], theta, x.device))


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections: tuple[int, ...], *, theta: float = 1e6
                ) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: positions3 (..., S, 3) = (t, h, w) ids;
    the hd/2 frequency slots are split into ``sections``, each rotated by
    its own position stream."""
    hd = x.shape[-1]
    assert sum(sections) == hd // 2, (sections, hd)
    pos = positions3.float()[..., _section_ids(tuple(sections), x.device)]
    return _rotate(x, pos * _freqs(hd, theta, x.device))     # (..., S, hd/2)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    causal: bool = True
    window: int | None = None          # sliding-window size (h2o-danube, gemma2 local)
    softcap: float | None = None       # gemma2 logit soft-capping
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] | None = None   # qwen2-vl


_EXACT_CAP_LIMIT = 4096   # max T for drop-free (cap = T) MoE dispatch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int                     # per-expert ffn
    n_shared: int = 0             # deepseek-v2 shared experts
    capacity_factor: float = 1.25


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """Gated MLP: ``down(act(x·gate) ⊙ x·up)``, the activation in f32."""

    def __init__(self, d_model: int, d_ff: int, dtype, init: ParamInit):
        super().__init__()
        self.up = init.dense((d_model, d_ff), dtype)
        self.down = init.dense((d_ff, d_model), dtype, fan_in=d_ff)
        self.gate = init.dense((d_model, d_ff), dtype)

    def forward(self, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
        up = torch.matmul(x, self.up)
        g = torch.matmul(x, self.gate).float()
        h = (F.silu(g) if act == "silu" else gelu(g)) * up.float()
        return torch.matmul(h.to(x.dtype), self.down)


# ---------------------------------------------------------------------------
# Mixture of Experts (sort-based dispatch, capacity-bounded)
# ---------------------------------------------------------------------------

class MoE(nn.Module):
    def __init__(self, cfg: MoEConfig, dtype, init: ParamInit):
        super().__init__()
        E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.cfg = cfg
        self.router = init.dense((d, E), torch.float32)
        self.gate = init.dense((E, d, f), dtype)
        self.up = init.dense((E, d, f), dtype)
        self.down = init.dense((E, f, d), dtype, fan_in=f)
        if cfg.n_shared:
            self.shared = MLP(d, f * cfg.n_shared, dtype, init)

    def forward(self, x: torch.Tensor, *, exact: bool = False) -> torch.Tensor:
        """Capacity-bounded top-k MoE with sort-based dispatch: assignments
        sorted (stably) by expert, each one's slot its rank within its
        expert, ranks ≥ capacity dropped to the sink row ``E·cap``.
        ``exact=True`` (inference) sets capacity = T up to
        ``_EXACT_CAP_LIMIT`` tokens, so nothing drops; above it the
        capacity is ``ceil(T·k/E·capacity_factor)``, as in the reference.

        The top-k is a stable descending sort, so equal router
        probabilities go to the lower expert first, as ``lax.top_k``
        orders them."""
        cfg = self.cfg
        B, S, d = x.shape
        T, E, k = B * S, cfg.n_experts, cfg.top_k
        xt = x.reshape(T, d)
        probs = torch.softmax(torch.matmul(xt.float(), self.router), -1)
        if exact and T <= _EXACT_CAP_LIMIT:
            cap = T
        else:
            cap = int(np.ceil(T * k / E * cfg.capacity_factor))
        cap = max(cap, 1)
        eb, *route = shardctx.local("moe_dispatch", _moe_dispatch, xt, probs,
                                    k=k, cap=cap)
        g = dot_f32(eb, self.gate)
        u = dot_f32(eb, self.up)
        h = (F.silu(g) * u).to(x.dtype)
        out_e = torch.matmul(h, self.down)                      # (E,cap,d)
        yt = shardctx.local("moe_combine", _moe_combine, out_e, *route, T=T)
        y = shardctx.shard(yt.reshape(B, S, d), "hidden").to(x.dtype)
        if cfg.n_shared:
            y = y + self.shared(x)
        return y


def _moe_dispatch(xt, probs, *, k: int, cap: int):
    """Route T tokens to their top-k experts → (the dispatch buffer
    (E, cap, d), and the route: each assignment's slot in the buffer
    (``E·cap``, the sink, when dropped), token, weight and kept flag, in
    expert order)."""
    T, d = xt.shape
    E = probs.shape[-1]
    dev = xt.device
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, experts = vals[:, :k], idx[:, :k]
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    a_tok = torch.arange(T, device=dev).repeat_interleave(k)
    a_exp = experts.reshape(-1)
    order = torch.argsort(a_exp, stable=True)
    s_exp, s_tok, s_w = a_exp[order], a_tok[order], weights.reshape(-1)[order]
    first = torch.searchsorted(s_exp, torch.arange(E, device=dev),
                               side="left")
    rank = torch.arange(T * k, device=dev) - first[s_exp]
    keep = rank < cap
    slot = torch.where(keep, s_exp * cap + rank, E * cap)       # drop sink
    buf = torch.zeros((E * cap + 1, d), dtype=xt.dtype, device=dev)
    buf[slot] = torch.where(keep[:, None], xt[s_tok], 0)
    return buf[:E * cap].reshape(E, cap, d), slot, s_tok, s_w, keep


def _moe_combine(out_e, slot, s_tok, s_w, keep, *, T: int):
    """The experts' outputs (E, cap, d) weighted back onto their T tokens
    → (T, d) f32 (a sink slot adds a zero row)."""
    E, cap, d = out_e.shape
    flat = torch.cat([out_e.reshape(E * cap, d),
                      torch.zeros((1, d), dtype=out_e.dtype,
                                  device=out_e.device)])
    contrib = flat[slot] * s_w[:, None].to(out_e.dtype)         # (T*k, d)
    yt = torch.zeros((T, d), dtype=torch.float32, device=out_e.device)
    yt.index_add_(0, s_tok, torch.where(keep[:, None], contrib, 0).float())
    return yt


def moe_aux_loss(moe: MoE, x: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balancing loss of ``moe``'s router on x (B, S, d):
    E · Σ_e (share of tokens routed to e) · (mean router probability of
    e). Only the probabilities carry a gradient; the top-k is the stable
    sort ``MoE.forward`` takes, so ties go to the lower expert as
    ``lax.top_k`` sends them."""
    cfg = moe.cfg
    probs = torch.softmax(torch.matmul(x.reshape(-1, x.shape[-1]).float(),
                                       moe.router), -1)
    experts = torch.sort(probs.detach(), dim=-1, descending=True,
                         stable=True).indices[:, :cfg.top_k]
    onehot = F.one_hot(experts, cfg.n_experts).sum(1).float()   # (T, E)
    return cfg.n_experts * (onehot.mean(0) * probs.mean(0)).sum()
