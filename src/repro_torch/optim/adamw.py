"""Optimizers as plain functions on tensors (port of ``repro.optim.adamw``).

Parameters, grads and states are dicts from a model's parameter names to
tensors (``dict(model.named_parameters())``), so the states mirror the
parameters leaf for leaf and live on their devices. ``update(grads, state,
params, lr)`` follows the reference's formulas: each leaf is computed in
f32 and rounded once to the parameter's dtype, moments are kept in
``moment_dtype``, bias correction is exact, and weight decay is
``p − lr·(upd + wd·p)`` on every leaf. It writes the new parameters and
states in place (under ``no_grad``) and returns them.

This is not ``torch.optim.AdamW``: on bf16 parameters that keeps its
moments in bf16 whatever is asked and rounds twice a step, so its result is
not the reference's.

The grads are f32 and owned by the caller's step: ``clip_by_global_norm``
scales them in place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tree = dict


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    update: Callable[..., tuple[Tree, Tree]]
    # update(grads, state, params, lr) -> (params, state), both in place


def global_norm(tree: Tree) -> torch.Tensor:
    """√(Σ leaf²) in f32 over every leaf, as a device scalar."""
    return torch.sqrt(sum(t.float().square().sum() for t in tree.values()))


@torch.no_grad()
def clip_by_global_norm(grads: Tree, max_norm: float) -> Tree:
    """Scale the f32 grads in place by min(1, max_norm / max(‖g‖, 1e-9))."""
    scale = torch.clamp(max_norm / torch.clamp(global_norm(grads), min=1e-9),
                        max=1.0)
    for g in grads.values():
        g.mul_(scale)
    return grads


def adamw(*, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, grad_clip: float | None = 1.0,
          moment_dtype=torch.float32) -> Optimizer:
    """AdamW. The step count lives in the state (an int32 device scalar);
    bias correction is exact."""

    def init(params: Tree) -> Tree:
        zeros = lambda p: torch.zeros_like(p, dtype=moment_dtype)
        step = torch.zeros((), dtype=torch.int32,
                           device=next(iter(params.values())).device)
        return dict(mu={n: zeros(p) for n, p in params.items()},
                    nu={n: zeros(p) for n, p in params.items()}, step=step)

    @torch.no_grad()
    def update(grads, state, params, lr):
        if grad_clip is not None:
            clip_by_global_norm(grads, grad_clip)
        state["step"].add_(1)
        t = state["step"].float()
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)
        for name, p in params.items():
            g = grads[name].float()
            mu, nu = state["mu"][name], state["nu"][name]
            mu2 = b1 * mu.float() + (1 - b1) * g
            nu2 = b2 * nu.float() + (1 - b2) * g * g
            upd = (mu2 / c1) / (torch.sqrt(nu2 / c2) + eps)
            pf = p.float()
            p.copy_(pf - lr * (upd + weight_decay * pf))
            mu.copy_(mu2)
            nu.copy_(nu2)
        return params, state

    return Optimizer(init=init, update=update)


def adafactor(*, stack_of: Callable[[str], str] | None, decay: float = 0.8,
              eps: float = 1e-30, weight_decay: float = 0.0,
              grad_clip: float | None = 1.0,
              min_dim_size_to_factor: int = 128) -> Optimizer:
    """Adafactor (factored second moment, no first moment): a leaf whose
    last two axes are both ≥ ``min_dim_size_to_factor`` keeps row and
    column means ``r``/``c``, any other a full ``v``; the update is clipped
    by its RMS.

    ``stack_of`` (required, so that a ``Model`` is never clipped layer by
    layer by accident) maps a parameter name to the reference leaf it
    belongs to: on a ``Model`` it is ``functools.partial(
    models.model.stacked_name, cfg)``, since the reference stacks a period
    member's layers into one (G, ...) leaf and the RMS clip spans the
    whole stack. ``None`` makes every parameter its own leaf, for a tree
    whose leaves are the reference's. The per-layer factoring equals the
    stacked one's while G < ``min_dim_size_to_factor`` (a stacked 1-D
    leaf is then never factored)."""

    def _factored(shape) -> bool:
        return (len(shape) >= 2 and shape[-1] >= min_dim_size_to_factor
                and shape[-2] >= min_dim_size_to_factor)

    def init(params: Tree) -> Tree:
        def leaf(p):
            kw = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return dict(r=torch.zeros(p.shape[:-1], **kw),
                            c=torch.zeros(p.shape[:-2] + p.shape[-1:], **kw))
            return dict(v=torch.zeros(p.shape, **kw))
        step = torch.zeros((), dtype=torch.int32,
                           device=next(iter(params.values())).device)
        return dict(v={n: leaf(p) for n, p in params.items()}, step=step)

    def _leaf(g, v, shape, beta):
        """The leaf's second-moment state updated in place → its
        unclipped update g / √v̂."""
        g2 = g * g + eps
        if _factored(shape):
            r = beta * v["r"] + (1 - beta) * g2.mean(-1)
            c = beta * v["c"] + (1 - beta) * g2.mean(-2)
            rc = r.mean(-1, keepdim=True)
            vhat = (r[..., None] / torch.clamp(rc[..., None], min=eps)
                    ) * c[..., None, :]
            v["r"].copy_(r)
            v["c"].copy_(c)
        else:
            vhat = beta * v["v"] + (1 - beta) * g2
            v["v"].copy_(vhat)
        return g / torch.sqrt(vhat + eps)

    @torch.no_grad()
    def update(grads, state, params, lr):
        if grad_clip is not None:
            clip_by_global_norm(grads, grad_clip)
        state["step"].add_(1)
        beta = 1.0 - torch.pow(state["step"].float(), -decay)
        stacks: dict[str, list[str]] = {}
        for name in params:
            key = stack_of(name) if stack_of is not None else name
            stacks.setdefault(key, []).append(name)
        for names in stacks.values():
            upds = [_leaf(grads[k].float(), state["v"][k], params[k].shape,
                          beta) for k in names]
            # update clipping (Adafactor's RMS trick) over the whole leaf
            rms = torch.sqrt(sum((u * u).sum() for u in upds)
                             / sum(u.numel() for u in upds))
            for k, upd in zip(names, upds):
                upd = upd / torch.clamp(rms, min=1.0)
                p = params[k]
                pf = p.float()
                p.copy_(pf - lr * (upd + weight_decay * pf))
        return params, state

    return Optimizer(init=init, update=update)
