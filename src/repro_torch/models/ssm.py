"""Linear-recurrence mixers (port of ``repro.models.ssm``): RWKV6 (Finch)
and Mamba-1 (Jamba's SSM), each over a full sequence or with its state
carried from a previous call (one-token decode).

RWKV6 runs the reference's chunked closed form: within a chunk only
*differences* of cumulative log-decays are exponentiated, and the
sequence is padded to a chunk multiple with zero decay, so the chunk
boundaries (and hence the rounding) are the reference's. Mamba's
selective scan is sequential per token; the reference's chunking only
bounds its backward memory, and its padded steps leave the state as it
is, so the port scans the S real tokens, as one op (``mamba_scan``, the
loop on every device; its backward recomputes the loop under autograd).

JAX names: ``rwkv6_init``/``rwkv6_apply`` are ``RWKV6``/``RWKV6.forward``;
``mamba_init``/``mamba_apply`` are ``Mamba``/``Mamba.forward``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.models import shardctx
from repro_torch.models.layers import ParamInit, rms_norm


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RWKV6Config:
    d_model: int
    n_heads: int               # head_dim = d_model // n_heads
    decay_lora: int = 64       # low-rank data-dependent decay
    chunk: int = 64

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _rwkv6_chunk(r, k, v, logw, u, state):
    """One chunk of the wkv recurrence.

    r/k/v: (B,H,Q,hd); logw: (B,H,Q,hd) per-channel log-decay (≤ 0);
    u: (H,hd) bonus; state: (B,H,hd,hd) [k-dim × v-dim].
    S_t = diag(a_t) S_{t-1} + k_tᵀ v_t, a_t = exp(logw_t);
    y_t = r_t·S_{t-1} + (r_t·(u ⊙ k_t)) v_t.
    """
    Q = r.shape[2]
    L = torch.cumsum(logw, dim=2)                         # inclusive
    Lprev = L - logw                                      # exclusive
    y = torch.einsum("bhqc,bhcv->bhqv", r * torch.exp(Lprev), state)
    diff = Lprev[:, :, :, None, :] - L[:, :, None, :, :]  # (B,H,Q,Q,hd)
    ar = torch.arange(Q, device=r.device)
    tri = (ar[:, None] > ar[None, :])[None, None, :, :, None]
    D = torch.where(tri, torch.exp(diff), 0.0)
    scores = (r[:, :, :, None, :] * k[:, :, None, :, :] * D).sum(-1)
    y = y + torch.einsum("bhts,bhsv->bhtv", scores, v)
    y = y + (r * (u[None, :, None, :] * k)).sum(-1)[..., None] * v
    Lq = L[:, :, -1:, :]                                  # (B,H,1,hd)
    k_scaled = k * torch.exp(Lq - L)
    state = state * torch.exp(Lq[:, :, 0, :, None]) + torch.einsum(
        "bhsc,bhsv->bhcv", k_scaled, v)
    return y, state


def _rwkv6_scan(r, k, v, logw, u, state, *, Q: int):
    """The wkv recurrence over a padded sequence, chunk by chunk →
    (y (B,H,S,hd) f32, the final state)."""
    ys = []
    for c in range(r.shape[2] // Q):
        cs = slice(c * Q, (c + 1) * Q)
        y, state = _rwkv6_chunk(r[:, :, cs].float(), k[:, :, cs].float(),
                                v[:, :, cs].float(), logw[:, :, cs], u, state)
        ys.append(y)
    return torch.cat(ys, 2), state


class RWKV6(nn.Module):
    def __init__(self, cfg: RWKV6Config, dtype, init: ParamInit):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        self.cfg = cfg
        self.mix = init.uniform((5, d), dtype)
        self.r = init.dense((d, d), dtype)
        self.k = init.dense((d, d), dtype)
        self.v = init.dense((d, d), dtype)
        self.g = init.dense((d, d), dtype)
        self.o = init.dense((d, d), dtype)
        self.w_base = init.normal((d,), torch.float32, -5.0, 0.1)
        self.w_a = init.dense((d, cfg.decay_lora), dtype)
        self.w_b = init.dense((cfg.decay_lora, d), dtype,
                              fan_in=cfg.decay_lora)
        self.u = init.normal((cfg.n_heads, hd), torch.float32, 0.0, 0.3)
        self.ln = init.zeros((d,))

    def forward(self, x: torch.Tensor, state: dict | None = None):
        """state: dict(s=(B,H,hd,hd) f32, shift=(B,d) the last token).
        Returns (y, new_state)."""
        cfg = self.cfg
        B, S, d = x.shape
        H, hd = cfg.n_heads, cfg.head_dim
        prev = (torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)
                if state is None else state["shift"][:, None, :].to(x.dtype))
        xs = torch.cat([prev, x[:, :-1]], 1)
        mix = self.mix.float()

        def mixed(i):
            m = mix[i]
            return (x.float() * m + xs.float() * (1 - m)).to(x.dtype)

        heads = lambda t: t.reshape(B, S, H, hd).transpose(1, 2)
        r = heads(torch.matmul(mixed(0), self.r))
        k = heads(torch.matmul(mixed(1), self.k))
        v = heads(torch.matmul(mixed(2), self.v))
        g = torch.matmul(mixed(3), self.g)
        # the low-rank decay's row-parallel output pinned, as a block's are
        w = self.w_base.float() + shardctx.shard(torch.matmul(
            torch.matmul(mixed(4), self.w_a), self.w_b), "hidden").float()
        logw = heads(-torch.exp(w))                         # ≤ 0
        u = self.u.float()
        s = (torch.zeros((B, H, hd, hd), device=x.device) if state is None
             else state["s"])
        Q = min(cfg.chunk, S)
        pad = (-S) % Q                 # zero decay: pads change nothing
        zpad = lambda t: F.pad(t, (0, 0, 0, pad)) if pad else t
        r, k, v, logw = zpad(r), zpad(k), zpad(v), zpad(logw)
        y, s = shardctx.local("rwkv", _rwkv6_scan, r, k, v, logw, u, s, Q=Q)
        # gathered over the model axis before the norm reduces over it
        y = shardctx.shard(y[:, :, :S].transpose(1, 2).reshape(B, S, d),
                           "hidden")
        y = rms_norm(y.to(x.dtype), self.ln)
        y = (F.silu(g.float()) * y.float()).to(x.dtype)
        return torch.matmul(y, self.o), dict(s=s, shift=x[:, -1, :])


# ---------------------------------------------------------------------------
# Mamba-1 (Jamba's SSM mixer)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int | None = None
    chunk: int = 64

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def rank(self) -> int:
        return self.dt_rank or max(self.d_model // 16, 1)


def _mamba_inner_scan(h, dt, B_in, C_in, xin, A):
    """Sequential selective scan. h: (B, di, n); dt/xin: (B, S, di);
    B_in/C_in: (B, S, n); A: (di, n). Returns (h, y (B, S, di)).

    The inputs are split into tokens once (``unbind``), so autograd's
    backward stacks their grads once; a slice a token (``dt[:, t]``)
    would give every token a grad of the whole (B, S, ·) input."""
    ys = []
    for dt_t, x_t, b_t, c_t in zip(dt.unbind(1), xin.unbind(1),
                                   B_in.unbind(1), C_in.unbind(1)):
        da = torch.exp(dt_t[:, :, None] * A[None])
        h = da * h + (dt_t * x_t)[:, :, None] * b_t[:, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c_t))
    return h, torch.stack(ys, 1)


# The scan as one op each way, so that a dispatch mode sees one op where
# the loop runs ~4 ops a token: the dry run's cost counter prices it from
# its own count of the loop (``roofline.cost``), and a jamba cell of 4,096
# tokens traces in seconds. Both run the loop above on every device; the
# backward recomputes it under autograd, so its grads are the loop's.

@torch.library.custom_op("repro_torch::mamba_scan", mutates_args=())
def mamba_scan(h: torch.Tensor, dt: torch.Tensor, B_in: torch.Tensor,
               C_in: torch.Tensor, xin: torch.Tensor, A: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``_mamba_inner_scan`` as one op → (h, y)."""
    return _mamba_inner_scan(h, dt, B_in, C_in, xin, A)


@mamba_scan.register_fake
def _(h, dt, B_in, C_in, xin, A):
    return h.new_empty(h.shape), h.new_empty(dt.shape)


def mamba_scan_grads(h, dt, B_in, C_in, xin, A, g_h, g_y, needs):
    """The grads of ``_mamba_inner_scan`` with respect to the inputs that
    ``needs`` marks, for the output grads ``g_h``, ``g_y`` (None: that
    output is unused), from the loop recomputed under autograd; an input
    not needed gets an empty tensor."""
    K = torch._C.DispatchKey
    # autograd is excluded below an op's autograd layer: let it record
    with torch._C._SetExcludeDispatchKeyGuard(K.AutogradFunctionality,
                                               False), \
            torch._C._SetExcludeDispatchKeyGuard(K.ADInplaceOrView, False), \
            torch.enable_grad():
        ins = [t.detach().requires_grad_(n)
               for t, n in zip((h, dt, B_in, C_in, xin, A), needs)]
        outs = [(o, g) for o, g in zip(_mamba_inner_scan(*ins), (g_h, g_y))
                if g is not None]
        want = [t for t in ins if t.requires_grad]
        grads = iter(torch.autograd.grad([o for o, _ in outs], want,
                                         [g for _, g in outs],
                                         allow_unused=True)
                     if want and outs else ())
    out = []
    for t in ins:
        g = next(grads) if t.requires_grad else None
        out.append(torch.zeros_like(t) if t.requires_grad and g is None
                   else t.new_empty(0) if g is None else g)
    return out


@torch.library.custom_op("repro_torch::mamba_scan_backward",
                         mutates_args=())
def mamba_scan_backward(h: torch.Tensor, dt: torch.Tensor,
                        B_in: torch.Tensor, C_in: torch.Tensor,
                        xin: torch.Tensor, A: torch.Tensor,
                        g_h: torch.Tensor | None, g_y: torch.Tensor | None,
                        needs: list[bool]) -> list[torch.Tensor]:
    """``mamba_scan_grads`` as one op."""
    return mamba_scan_grads(h, dt, B_in, C_in, xin, A, g_h, g_y, needs)


@mamba_scan_backward.register_fake
def _(h, dt, B_in, C_in, xin, A, g_h, g_y, needs):
    return [t.new_empty(t.shape if n else (0,))
            for t, n in zip((h, dt, B_in, C_in, xin, A), needs)]


def _scan_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)
    ctx.set_materialize_grads(False)     # an unused output's grad is None


def _scan_backward(ctx, g_h, g_y):
    needs = list(ctx.needs_input_grad)
    if not any(needs):
        return (None,) * 6
    grads = mamba_scan_backward(*ctx.saved_tensors, g_h, g_y, needs)
    return tuple(g if n else None for g, n in zip(grads, needs))


mamba_scan.register_autograd(_scan_backward, setup_context=_scan_setup)


class Mamba(nn.Module):
    def __init__(self, cfg: MambaConfig, dtype, init: ParamInit):
        super().__init__()
        d, di, n, r = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.rank
        self.cfg = cfg
        self.in_proj = init.dense((d, 2 * di), dtype)
        self.conv = init.dense((cfg.d_conv, di), dtype, fan_in=cfg.d_conv)
        self.conv_b = init.zeros((di,))
        self.x_proj = init.dense((di, r + 2 * n), dtype)
        self.dt_proj = init.dense((r, di), dtype, fan_in=r)
        lo, hi = np.log(0.001), np.log(0.1)
        self.dt_bias = init.param(
            (di,), torch.float32, lambda t: t.uniform_(
                0, 1, generator=init.generator).mul_(hi - lo).add_(lo)
            .exp_().expm1_().log_())
        self.A_log = init.const(np.log(np.tile(
            np.arange(1, n + 1, dtype=np.float32)[None, :], (di, 1))))
        self.D = init.const(np.ones((di,), np.float32))
        self.out_proj = init.dense((di, d), dtype, fan_in=di)

    def forward(self, x: torch.Tensor, state: dict | None = None):
        """state: dict(h=(B,di,n) f32, conv=(B,d_conv-1,di)). Returns
        (y, new_state)."""
        cfg = self.cfg
        B, S, d = x.shape
        di, n = cfg.d_inner, cfg.d_state
        # column-parallel, as the reference's: unpinned, DTensor gathers the
        # weight to split the product's columns in two
        xi, z = shardctx.shard(torch.matmul(x, self.in_proj),
                               "cols").chunk(2, dim=-1)
        prev = (torch.zeros((B, cfg.d_conv - 1, di), dtype=xi.dtype,
                            device=x.device)
                if state is None else state["conv"].to(xi.dtype))
        xc = torch.cat([prev, xi], 1)
        conv_w = self.conv.float()
        xi = sum(xc[:, i:i + S].float() * conv_w[i]
                 for i in range(cfg.d_conv))
        xi = F.silu(xi + self.conv_b).to(x.dtype)
        new_conv = xc[:, S:]
        # gathered over the model axis before it is split three ways
        proj = shardctx.shard(torch.matmul(xi, self.x_proj), "hidden").float()
        dt_low, B_in, C_in = proj.split([cfg.rank, n, n], dim=-1)
        dt = F.softplus(torch.matmul(dt_low.to(x.dtype), self.dt_proj).float()
                        + self.dt_bias)
        A = -torch.exp(self.A_log)
        h = (torch.zeros((B, di, n), device=x.device) if state is None
             else state["h"])
        xf = xi.float()
        h, y = shardctx.local("mamba", mamba_scan, h, dt, B_in, C_in, xf, A)
        y = y + xf * self.D
        y = (y * F.silu(z.float())).to(x.dtype)
        return torch.matmul(y, self.out_proj), dict(h=h, conv=new_conv)
