"""Memory-bounded attention for the 10-arch zoo (port of
``repro.models.attention``), in plain torch.

``chunked_attend`` is online-softmax attention over (q_blk, kv_blk) tiles,
so logits never grow past one tile; ``decode_attend`` is one unchunked
pass for a single query position against a whole cache. Both take GQA
(grouped, no KV repetition), causal or bidirectional masks, sliding
windows and logit soft-capping, and mask on *absolute* positions (kv
position −1 marks an empty cache slot). No library attention: SDPA has
neither the soft-cap nor masks from absolute positions.

Everything is computed in f32 as the reference does: q is scaled in f32
before the product, masked logits are −1e30, and the normaliser is
floored at 1e-30 for padded rows that every key masks.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.models.layers import call, recompute

_NEG = -1e30


def _block_mask(qp: torch.Tensor, kp: torch.Tensor, *, causal: bool,
                window: int | None) -> torch.Tensor:
    """(B, q_blk, kv_blk) bool mask from (B, q_blk), (B, kv_blk) positions."""
    kp, qp = kp[:, None, :], qp[:, :, None]
    m = kp >= 0
    if causal:
        m = m & (kp <= qp)
    if window is not None:
        m = m & (kp > qp - window)
    return m


def _softcap(logits: torch.Tensor, softcap: float | None) -> torch.Tensor:
    return softcap * torch.tanh(logits / softcap) if softcap else logits


def _kv_step(m_run, l_run, acc, qb, qpb, kb, vb, kpb, *, causal: bool,
             window: int | None, softcap: float | None):
    """One (q_blk, kv_blk) tile of the online softmax: the running max,
    normaliser and accumulator after the tile."""
    logits = _softcap(torch.einsum("bqkgh,bskh->bkgqs", qb, kb.float()),
                      softcap)
    mask = _block_mask(qpb, kpb, causal=causal, window=window)
    logits = torch.where(mask[:, None, None], logits, _NEG)
    m_new = torch.maximum(m_run, logits.amax(-1))
    alpha = torch.exp(m_run - m_new)
    p = torch.exp(logits - m_new[..., None])
    l_new = l_run * alpha + p.sum(-1)
    acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskh->bkgqh", p,
                                                vb.float())
    return m_new, l_new, acc


def _q_step(qb, qpb, kf, vf, kp, *, kv_blk: int, hd_v: int, remat, **kw):
    """One query block against every KV block → (B, q_blk, K, G, hd_v)."""
    B, q_blk, K, G, _ = qb.shape
    m_run = torch.full((B, K, G, q_blk), _NEG, device=qb.device)
    l_run = torch.zeros((B, K, G, q_blk), device=qb.device)
    acc = torch.zeros((B, K, G, q_blk, hd_v), device=qb.device)
    for j in range(kf.shape[1] // kv_blk):
        ks = slice(j * kv_blk, (j + 1) * kv_blk)
        m_run, l_run, acc = remat(functools.partial(_kv_step, **kw), m_run,
                                  l_run, acc, qb, qpb, kf[:, ks], vf[:, ks],
                                  kp[:, ks])
    out = acc / l_run[..., None].clamp_min(1e-30)     # (B,K,G,q_blk,hd_v)
    return out.permute(0, 3, 1, 2, 4)


def chunked_attend(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                   window: int | None = None, softcap: float | None = None,
                   q_blk: int = 512, kv_blk: int = 1024,
                   scale: float | None = None) -> torch.Tensor:
    """Online-softmax attention.

    q: (B, Sq, H, hd); k: (B, Skv, K, hd); v: (B, Skv, K, hd_v), H % K == 0;
    q_pos (B, Sq), kv_pos (B, Skv) absolute positions (−1: empty slot).
    Returns (B, Sq, H, hd_v) in q's dtype.

    Under autograd each KV tile and each query block is checkpointed, as
    the reference's ``jax.checkpoint`` of ``kv_step`` and ``q_step``: the
    backward pass recomputes the (q_blk, kv_blk) f32 probability tiles
    instead of keeping them (at tinyllama's width a micro-batch of 4 ×
    2,048 makes each tile 268 MB, eight a layer).
    """
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    G = H // K
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    q_blk, kv_blk = min(q_blk, Sq), min(kv_blk, Skv)
    qpad, kpad = (-Sq) % q_blk, (-Skv) % kv_blk
    pad = lambda t, n, val=0: torch.nn.functional.pad(
        t, (0, 0) * (t.dim() - 2) + (0, n), value=val) if n else t
    qf = pad(q, qpad)
    qp = pad(q_pos, qpad, -(2**30))
    kf, vf, kp = pad(k, kpad), pad(v, kpad), pad(kv_pos, kpad, -1)
    nq = qf.shape[1] // q_blk
    qt = qf.reshape(B, nq * q_blk, K, G, hd).float() * scale
    remat = recompute if torch.is_grad_enabled() else call
    step = functools.partial(_q_step, kv_blk=kv_blk, hd_v=hd_v, remat=remat,
                             causal=causal, window=window, softcap=softcap)
    outs = [remat(step, qt[:, i * q_blk:(i + 1) * q_blk],
                  qp[:, i * q_blk:(i + 1) * q_blk], kf, vf, kp)
            for i in range(nq)]
    out = torch.cat(outs, 1).reshape(B, nq * q_blk, H, hd_v)
    return out[:, :Sq].to(q.dtype)


def decode_attend(q, k, v, q_pos, kv_pos, *, window: int | None = None,
                  softcap: float | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """Decode attention (Sq == 1) against a whole KV cache, in one pass:
    the logits are (B, H, Skv)."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    hd_v = v.shape[-1]
    G = H // K
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    qf = q.reshape(B, Sq, K, G, hd).float() * scale
    logits = _softcap(torch.einsum("bqkgh,bskh->bkgqs", qf, k.float()),
                      softcap)
    kp, qp = kv_pos[:, None, :], q_pos[:, :, None]
    mask = (kp >= 0) & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    logits = torch.where(mask[:, None, None], logits, _NEG)
    probs = torch.softmax(logits, -1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(B, Sq, H, hd_v).to(q.dtype)
