"""Unified language model over the block zoo (port of ``repro.models.model``).

A model is: input embedding (token table, or a stub frontend projection
for the [audio]/[vlm] archs) → ``n_layers`` blocks, G repetitions of a
*period* of ``BlockCfg``s → final RMS-norm → output head.

The reference stacks each period member's parameters on a leading group
axis and scans over the groups; the port holds the layers unstacked in a
``ModuleList``, layer ``g·P + m`` being group g's period member m, and
loops over them. Caches are one dict per layer in that order. Parameters
keep the reference's ``(in, out)`` layout, so carrying its weights
(``params_from_numpy``) only unstacks the group axis.

The serving entry points (``forward``, ``logits_fn``, ``prefill``,
``decode_step``, ``embed_sequence``) run under ``torch.inference_mode``
(``torch.no_grad`` under a sharder: DTensor's views cannot be made in
inference mode);
the training path (``train_forward``, ``loss_fn``) runs under autograd
with the reference's remat schedule (``ModelConfig.remat``): ``none``,
``full`` (one checkpoint per layer group) or ``2level`` (√G-chunked).

Entry points run on the card unless the caller names a device:
``init_params`` and ``params_from_numpy`` with ``device=None`` raise
without one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch
from torch import nn

from repro_torch.core.types import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import shardctx as _ctx
from repro_torch.models.layers import (ParamInit, call, dot_f32, recompute,
                                       rms_norm)


# activation-sharding hook: launchers install a sharder
# (models/sharding.py::make_act_sharder) whose ``shard(x, tag)`` pins the
# tagged activations' DTensor layouts, as the reference's
# with_sharding_constraint does; without one the hooks are the identity


@contextlib.contextmanager
def activation_sharding(fn, param_pin=None):
    tok = _ctx.set_sharder(fn)
    tok2 = _ctx.set_pin(param_pin)
    try:
        yield
    finally:
        _ctx.reset_sharder(tok)
        _ctx.reset_pin(tok2)


def _serving(fn):
    """Run ``fn`` under ``torch.inference_mode``, or ``torch.no_grad``
    while a sharder is installed."""
    @functools.wraps(fn)
    def run(*a, **kw):
        with (torch.no_grad() if _ctx.sharder() is not None
              else torch.inference_mode()):
            return fn(*a, **kw)
    return run


def shard_act(x: torch.Tensor, tag: str) -> torch.Tensor:
    return _ctx.shard(x, tag)


def pin_params(blocks):
    """The blocks as the installed pinner gives them: the reference
    re-asserts the FSDP×TP sharding of per-group param slices inside its
    scan bodies; the port's pinner gathers each block's FSDP shards when
    it is called (sharding.make_param_pinner)."""
    return _ctx.pin(blocks)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    period: tuple[B.BlockCfg, ...]
    dtype: torch.dtype = torch.bfloat16
    input_kind: str = "tokens"        # tokens | embeddings (stub frontend)
    frontend_dim: int | None = None   # raw frame/patch embedding width
    encoder_only: bool = False        # hubert: no decode path
    tie_embeddings: bool = False
    final_softcap: float | None = None  # gemma2 final-logit soft-capping
    emb_scale: bool = False             # gemma2 scales embeddings by √d
    remat: str = "full"                 # none | full | 2level (training)
    pos_dims: int = 1                   # 3 ⇒ M-RoPE (t, h, w) position ids
    moe_aux_weight: float = 0.01

    @property
    def n_groups(self) -> int:
        assert self.n_layers % len(self.period) == 0, (
            self.n_layers, len(self.period))
        return self.n_layers // len(self.period)

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def block_cfg(self, layer: int) -> B.BlockCfg:
        return self.period[layer % len(self.period)]


class Model(nn.Module):
    """The model's parameters: ``embed`` (vocab, d), ``in_proj`` (frontend
    archs), ``layers`` (n_layers ``Block``s), ``final_norm`` and ``head``
    (untied archs)."""

    def __init__(self, cfg: ModelConfig, init: ParamInit):
        super().__init__()
        self.cfg = cfg
        self.embed = init.dense((cfg.vocab, cfg.d_model), cfg.dtype)
        if cfg.input_kind == "embeddings":
            self.in_proj = init.dense((cfg.frontend_dim, cfg.d_model),
                                      cfg.dtype)
        self.layers = nn.ModuleList(
            B.Block(cfg.block_cfg(i), cfg.dtype, init)
            for i in range(cfg.n_layers))
        self.final_norm = init.zeros((cfg.d_model,))
        if not cfg.tie_embeddings:
            self.head = init.dense((cfg.d_model, cfg.vocab), cfg.dtype)

    def forward(self, inputs, positions, *, exact_moe: bool = False):
        return forward(self, inputs, positions, exact_moe=exact_moe)


# ---------------------------------------------------------------------------
# init / weight carry / counts
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, *, device=None,
                generator: torch.Generator | None = None) -> Model:
    """A model with random weights drawn on ``device`` (``None``: the
    card) from ``generator`` (a generator on that device; seed 0 if
    none)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return Model(cfg, ParamInit(device, generator))


def params_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> Model:
    """The reference's ``init_params`` pytree, as numpy arrays, carried
    into a ``Model`` on ``device`` (``None``: the card) computing the same
    function. ``tree["layers"]`` is a tuple of P dicts with (G, ...)
    leaves; layer ``g·P + m`` takes ``tree["layers"][m][...][g]``. bf16
    leaves (ml_dtypes) are carried through f32, which is lossless."""
    device = resolve_device(device)
    model = Model(cfg, ParamInit("meta")).to_empty(device=device)
    P = len(cfg.period)
    with torch.no_grad():
        for name, p in model.named_parameters():
            path = name.split(".")
            if path[0] == "layers":
                i = int(path[1])
                leaf = tree["layers"][i % P]
                for key in path[2:]:
                    leaf = leaf[key]
                leaf = np.asarray(leaf)[i // P]
            else:
                leaf = np.asarray(tree[name])
            if (tuple(leaf.shape), leaf.dtype.name) != (
                    tuple(p.shape), str(p.dtype).removeprefix("torch.")):
                raise ValueError(f"{name}: {leaf.dtype}{leaf.shape} is not "
                                 f"the port's {p.dtype}{tuple(p.shape)}")
            if leaf.dtype.name == "bfloat16":
                leaf = leaf.astype(np.float32)
            p.copy_(torch.from_numpy(np.array(leaf)))
    return model


def _to_numpy(t):
    """A tensor (or a dict of them) on the host as numpy; bf16 as f32,
    which is lossless."""
    if isinstance(t, dict):
        return {k: _to_numpy(v) for k, v in t.items()}
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _stack(leaves):
    if isinstance(leaves[0], dict):
        return {k: _stack([lf[k] for lf in leaves]) for k in leaves[0]}
    return np.stack(leaves)


def params_to_numpy(cfg: ModelConfig, named) -> dict:
    """``params_from_numpy``'s inverse: a ``Model``'s parameters, or any
    mapping from its parameter names to tensors (its grads, an optimizer
    state's moments, Adafactor's ``{r, c}``/``{v}`` dicts), as the
    reference's pytree of numpy arrays: ``layers`` a tuple of P dicts with
    (G, ...) leaves stacked from layers m, P + m, 2P + m, ... bf16 comes
    back as f32 (lossless)."""
    if isinstance(named, nn.Module):
        named = dict(named.named_parameters())
    P = len(cfg.period)
    tree: dict = {}
    stacks: dict = {}
    for name, t in named.items():
        path = name.split(".")
        if path[0] == "layers":
            i = int(path[1])
            stacks.setdefault((i % P, tuple(path[2:])),
                              [None] * cfg.n_groups)[i // P] = _to_numpy(t)
        else:
            tree[name] = _to_numpy(t)
    layers = [{} for _ in range(P)]
    for (m, path), leaves in stacks.items():
        node = layers[m]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _stack(leaves)
    tree["layers"] = tuple(layers)
    return tree


def stacked_name(cfg: ModelConfig, name: str) -> str:
    """The reference leaf a parameter belongs to: layer ``g·P + m`` is
    slice g of the reference's (G, ...) leaf of period member m, so
    ``layers.<i>.<rest>`` maps to ``layers.<i mod P>.<rest>``; other names
    are their own leaf. (Adafactor clips by the RMS of a whole reference
    leaf: ``adafactor(stack_of=...)``.)"""
    path = name.split(".")
    if path[0] == "layers":
        path[1] = str(int(path[1]) % len(cfg.period))
    return ".".join(path)


def _shapes(cfg: ModelConfig):
    """(name, shape) of every parameter, allocating nothing."""
    return [(n, p.shape) for n, p in
            Model(cfg, ParamInit("meta")).named_parameters()]


def param_count(cfg: ModelConfig) -> int:
    return sum(int(np.prod(s)) for _, s in _shapes(cfg))


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: top_k of the routed experts):
    a layer tensor whose leading axis is the expert axis counts k/E of
    itself, the reference's rule on its (G, E, ...) stacked leaves."""
    moe = next((bc.moe for bc in cfg.period if bc.moe is not None), None)
    total = 0
    for name, shape in _shapes(cfg):
        n = int(np.prod(shape))
        if (moe is not None and name.startswith("layers.")
                and len(shape) >= 2 and shape[0] == moe.n_experts):
            n = n // moe.n_experts * moe.top_k
        total += n
    return total


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids.long()]


def _embed_inputs(model: Model, inputs: torch.Tensor) -> torch.Tensor:
    """Token ids → table lookup; float frame/patch embeddings → the stub
    frontend projection. Dispatch on dtype, so [vlm]/[audio] archs take
    embeddings at prefill and text tokens at decode."""
    cfg = model.cfg
    if inputs.dtype.is_floating_point:
        h = torch.matmul(inputs.to(cfg.dtype), model.in_proj)
    else:
        h = _ctx.local("embed", _lookup, model.embed, inputs)
    if cfg.emb_scale:
        h = (h.float() * np.sqrt(cfg.d_model)).to(cfg.dtype)
    return h


@_serving
def forward(model: Model, inputs, positions, *, exact_moe: bool = False
            ) -> torch.Tensor:
    """Full-sequence forward → final-normed hidden states (B, S, d).
    ``exact_moe``: capacity = T in MoE dispatch (no drops), the inference
    semantics."""
    h = shard_act(_embed_inputs(model, inputs), "hidden")
    for blk in pin_params(model.layers):
        h = shard_act(blk(h, positions, exact_moe=exact_moe), "hidden")
    return rms_norm(h, model.final_norm)


def _group(model: Model, g: int, h, positions):
    """Layer group g (period members 0..P−1) → (h, the group's MoE aux),
    with the capacity-bounded MoE dispatch of training."""
    P = len(model.cfg.period)
    aux = torch.zeros((), device=h.device)
    for blk in pin_params(model.layers[g * P:(g + 1) * P]):
        h, a = blk(h, positions, exact_moe=False, with_aux=True)
        h = shard_act(h, "hidden")
        aux = aux + a
    return h, aux


def remat_chunk(G: int) -> int:
    """``2level``'s chunk of G layer groups: the largest divisor of G up
    to √G (the reference's)."""
    c = max(int(np.sqrt(G)), 1)
    while G % c:
        c -= 1
    return c


def train_forward(model: Model, inputs, positions
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward, under autograd → (final-normed hidden states
    (B, S, d), total MoE aux loss). ``cfg.remat`` picks what the backward
    pass recomputes, as in the reference: ``none`` keeps every layer's
    activations, ``full`` checkpoints each layer group, and ``2level``
    checkpoints chunks of c ≈ √G groups and each group within them (G/c + c
    saved boundaries for about one extra forward)."""
    cfg = model.cfg
    h = shard_act(_embed_inputs(model, inputs), "hidden")
    G = cfg.n_groups

    def group(g):
        return lambda h, positions: _group(model, g, h, positions)

    if cfg.remat == "2level":
        c = remat_chunk(G)

        def chunk(k):
            def run(h, positions):
                auxs = []
                for g in range(k * c, (k + 1) * c):
                    h, a = recompute(group(g), h, positions)
                    auxs.append(a)
                return h, torch.stack(auxs).sum()
            return run

        auxs = []
        for k in range(G // c):
            h, a = recompute(chunk(k), h, positions)
            auxs.append(a)
    elif cfg.remat in ("full", "none"):
        run = recompute if cfg.remat == "full" else call
        auxs = []
        for g in range(G):
            h, a = run(group(g), h, positions)
            auxs.append(a)
    else:
        raise ValueError(f"remat {cfg.remat!r}: none, full or 2level")
    return rms_norm(h, model.final_norm), torch.stack(auxs).sum()


def _logits(model: Model, h: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    w = model.embed.t() if cfg.tie_embeddings else model.head
    out = dot_f32(shard_act(h, "block_in"), w)
    if cfg.final_softcap:
        out = cfg.final_softcap * torch.tanh(out / cfg.final_softcap)
    return shard_act(out, "logits")


@_serving
def logits_fn(model: Model, h: torch.Tensor) -> torch.Tensor:
    """f32 logits (not rounded to the model's dtype), soft-capped for
    gemma2."""
    return _logits(model, h)


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """−log softmax(logits)[target] per token; 0 where the target is −1
    (padding)."""
    valid = targets >= 0
    tgt = torch.where(valid, targets, 0).long()
    logz = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, tgt[..., None])[..., 0]
    return torch.where(valid, logz - gold, 0.0)


def loss_fn(model: Model, batch: dict) -> tuple[torch.Tensor, dict]:
    """Cross-entropy plus ``moe_aux_weight`` × the MoE aux loss, under
    autograd → (total, {loss, aux, ntok}). batch: ``inputs``, ``targets``
    (B, S; −1 = padding, not counted), ``positions`` (B, S) or (B, S, 3)."""
    cfg = model.cfg
    h, aux = train_forward(model, batch["inputs"], batch["positions"])
    logits = _logits(model, h)                            # (B, S, V) f32
    targets = batch["targets"]
    nll = _ctx.local("xent", token_nll, logits, targets)
    ntok = (targets >= 0).sum().clamp_min(1)
    loss = nll.sum() / ntok
    total = loss + cfg.moe_aux_weight * aux
    return total, dict(loss=loss, aux=aux, ntok=ntok)


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, s_max: int, device
                ) -> list[dict]:
    """Empty decode caches, one dict per layer."""
    return [B.block_init_cache(cfg.block_cfg(i), batch, s_max, cfg.dtype,
                               device) for i in range(cfg.n_layers)]


@_serving
def prefill(model: Model, inputs, positions, s_max: int
            ) -> tuple[torch.Tensor, list[dict]]:
    """Consume a prompt; return (last-position logits (B, V) f32, caches)."""
    h = shard_act(_embed_inputs(model, inputs), "hidden")
    caches = []
    for blk in pin_params(model.layers):
        h, c = blk.prefill(h, positions, s_max)
        h = shard_act(h, "hidden")
        caches.append(c)
    h = rms_norm(h[:, -1:], model.final_norm)
    return logits_fn(model, h)[:, 0], caches


@_serving
def decode_step(model: Model, tokens, positions, caches: list[dict],
                cache_index) -> tuple[torch.Tensor, list[dict]]:
    """One decode step. tokens (B, 1) int (or (B, 1, fd) embeddings);
    positions (B, 1) (or (B, 1, 3)); cache_index (B,) = tokens so far per
    lane (ragged: continuous batching). Attention and latent caches are
    updated in place. Returns (logits (B, V) f32, the caches)."""
    h = _embed_inputs(model, tokens)
    new = []
    for blk, c in zip(pin_params(model.layers), caches):
        h, c = blk.decode(h, positions, c, cache_index)
        new.append(c)
    h = rms_norm(h[:, -1:], model.final_norm)
    return logits_fn(model, h)[:, 0], new


@_serving
def embed_sequence(model: Model, inputs, positions, *, pool: str = "last"
                   ) -> torch.Tensor:
    """Final hidden states pooled to one f32 vector per sequence."""
    h = forward(model, inputs, positions)
    if pool == "mean":
        return h.float().mean(1)
    return h[:, -1, :].float()
