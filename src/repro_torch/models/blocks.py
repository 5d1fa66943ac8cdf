"""Transformer-block compositions for the 10-arch zoo (port of
``repro.models.blocks``).

A block is mixer + FFN with pre-norms (optionally gemma2's sandwich
post-norms):

    h = h + [post_norm](mixer(norm(h)))
    h = h + [post_norm](ffn(norm(h)))

Mixers: ``attn`` (GQA / SWA / softcap / M-RoPE), ``mla`` (DeepSeek-V2
multi-head latent attention: latent KV cache, absorbed decode), ``mamba``
and ``rwkv``. FFNs: gated MLP or MoE.

Decode caches: attn → (k, v, pos), a ring of the last W tokens for
windowed layers; mla → the latent (c ⊕ k_rope); mamba/rwkv → their
recurrent state. Decode writes each lane's row of an attention or latent
cache *in place* (lane b at its own ``cache_index[b]``), so a step costs
no copy of the caches; a lane at length 0 writes slot 0, which a refill
overwrites.

JAX names: ``mla_init``/``gqa_init``/``block_init`` are the ``MLA``/
``GQA``/``Block`` constructors; ``*_attend_full``, ``*_prefill_cache`` and
``*_attend_decode`` are the mixers' ``attend_full``/``prefill_cache``/
``attend_decode``; ``block_apply_full``/``block_prefill_cache``/
``block_apply_decode`` are ``Block.forward``/``prefill``/``decode``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.models import shardctx, ssm
from repro_torch.models.attention import chunked_attend, decode_attend
from repro_torch.models.layers import (MLP, AttnConfig, MoE, MoEConfig,
                                       ParamInit, apply_mrope, apply_rope,
                                       moe_aux_loss, rms_norm)


# ---------------------------------------------------------------------------
# MLA — DeepSeek-V2 multi-head latent attention (arXiv:2405.04434)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128
    rope_theta: float = 10000.0

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    @property
    def latent_dim(self) -> int:       # cached per token
        return self.kv_lora_rank + self.qk_rope_dim


class MLA(nn.Module):
    def __init__(self, cfg: MLAConfig, dtype, init: ParamInit):
        super().__init__()
        d, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
        self.cfg = cfg
        self.q_a = init.dense((d, cfg.q_lora_rank), dtype)
        self.q_norm = init.zeros((cfg.q_lora_rank,))
        self.q_b = init.dense((cfg.q_lora_rank, H * cfg.qk_dim), dtype,
                              fan_in=cfg.q_lora_rank)
        self.kv_a = init.dense((d, r + cfg.qk_rope_dim), dtype)
        self.kv_norm = init.zeros((r,))
        self.k_b = init.dense((r, H * cfg.qk_nope_dim), dtype, fan_in=r)
        self.v_b = init.dense((r, H * cfg.v_dim), dtype, fan_in=r)
        self.o = init.dense((H * cfg.v_dim, d), dtype, fan_in=H * cfg.v_dim)

    def _latent(self, x, positions):
        """The cached latent's two parts: c (B,S,r) and k_rope (B,S,1,rope)."""
        cfg = self.cfg
        # the low-rank projections' outputs gathered over the model axis
        # before their norms reduce over it
        kv_low = shardctx.shard(torch.matmul(x, self.kv_a), "hidden")
        c = rms_norm(kv_low[..., :cfg.kv_lora_rank], self.kv_norm)
        k_rope = apply_rope(kv_low[..., None, cfg.kv_lora_rank:], positions,
                            theta=cfg.rope_theta)
        return c, k_rope

    def _qc(self, x, positions):
        """Rotated per-head q (nope, rope parts) and the latent (c, k_rope)."""
        cfg = self.cfg
        B, S, _ = x.shape
        q_low = shardctx.shard(torch.matmul(x, self.q_a), "hidden")
        q = torch.matmul(rms_norm(q_low, self.q_norm),
                         self.q_b).reshape(B, S, cfg.n_heads, cfg.qk_dim)
        q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
        q_rope = apply_rope(q_rope, positions, theta=cfg.rope_theta)
        return (q_nope, q_rope) + self._latent(x, positions)

    def attend_full(self, x, positions):
        """Train/prefill path: the latent expanded to per-head K/V."""
        cfg = self.cfg
        B, S, _ = x.shape
        H = cfg.n_heads
        q_nope, q_rope, c, k_rope = self._qc(x, positions)
        k_nope = torch.matmul(c, self.k_b).reshape(B, S, H, cfg.qk_nope_dim)
        v = torch.matmul(c, self.v_b).reshape(B, S, H, cfg.v_dim)
        q = torch.cat([q_nope, q_rope], -1)
        k = torch.cat([k_nope, k_rope.expand(B, S, H, cfg.qk_rope_dim)], -1)
        out = shardctx.local("attend", chunked_attend, q, k, v, positions,
                             positions, causal=True,
                             scale=1.0 / np.sqrt(cfg.qk_dim))
        return torch.matmul(out.reshape(B, S, H * cfg.v_dim), self.o)

    def prefill_cache(self, x, positions, s_max: int) -> dict:
        """Latent cache after consuming x, padded to s_max."""
        c, k_rope = self._latent(x, positions)
        lat, pos = shardctx.local("prefill_cache", latent_cache,
                                  torch.cat([c, k_rope[:, :, 0]], -1),
                                  positions, s_max=s_max)
        return dict(lat=lat, pos=pos)

    def attend_decode(self, x, positions, cache: dict, cache_index):
        """Absorbed attention over the latent cache: scores are
        q_abs·c + q_rope·k_rope (an MQA with one shared key), values
        re-expanded through v_b after the softmax; the absorbed query and
        the re-expansion stay in f32. ``cache_index`` (B,) per lane."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, r = cfg.n_heads, cfg.kv_lora_rank
        q_nope, q_rope, c, k_rope = self._qc(x, positions)
        bidx = torch.arange(B, device=x.device)
        ci = cache_index.long()
        lat, pos = cache["lat"], cache["pos"]
        shardctx.local("cache_write", write_rows, lat, ci,
                       torch.cat([c, k_rope[:, :, 0]], -1)[:, 0], lanes=bidx)
        shardctx.local("cache_write", write_rows, pos, ci, positions[:, 0],
                       lanes=bidx)
        k_b = self.k_b.reshape(r, H, cfg.qk_nope_dim)
        q_abs = torch.einsum("bshn,rhn->bshr", q_nope.float(), k_b.float())
        q_eff = torch.cat([q_abs, q_rope.float()], -1)
        out_lat = shardctx.local(
            "decode_attend", decode_attend, q_eff, lat[:, :, None, :],
            lat[:, :, None, :r], positions, pos,
            scale=1.0 / np.sqrt(cfg.qk_dim))                     # (B,S,H,r)
        v_b = self.v_b.reshape(r, H, cfg.v_dim)
        out = torch.einsum("bshr,rhv->bshv", out_lat.float(),
                           v_b.float()).to(x.dtype)
        return torch.matmul(out.reshape(B, S, H * cfg.v_dim), self.o), cache


# ---------------------------------------------------------------------------
# GQA attention with chunked softmax + (ring-buffered) KV cache
# ---------------------------------------------------------------------------

def write_rows(cache, slot, value, *, lanes):
    """``cache[b, slot[b]] = value[b]`` for every lane b (``lanes``, the
    caller's ``arange(B)``, made once for a layer's caches), in place → the
    cache."""
    cache[lanes, slot] = value.to(cache.dtype)
    return cache


def full_cache(k, v, p, *, s_max: int):
    """A full layer's cache after consuming k, v at positions p: slot =
    position, padded to s_max (empty slots at position −1)."""
    S = p.shape[1]
    pad = lambda t: nn.functional.pad(t, (0, 0, 0, 0, 0, s_max - S))
    return pad(k), pad(v), nn.functional.pad(p, (0, s_max - S), value=-1)


def latent_cache(lat, p, *, s_max: int):
    """MLA's latent cache, padded to s_max."""
    S = p.shape[1]
    return (nn.functional.pad(lat, (0, 0, 0, s_max - S)),
            nn.functional.pad(p, (0, s_max - S), value=-1))


def ring_cache(k, v, p, *, W: int):
    """A windowed layer's cache after consuming k, v at positions p: the
    last W tokens in ring order (slot = position % W). Only those W are
    written: positions p and p + W share a slot, and a scatter of both has
    no defined winner."""
    B, S = p.shape
    kc = k.new_zeros((B, W) + k.shape[2:])
    vc = v.new_zeros((B, W) + v.shape[2:])
    pc = p.new_full((B, W), -1)
    tail = slice(max(S - W, 0), S)
    slot = (p[:, tail] % W).long()
    bidx = torch.arange(B, device=p.device)[:, None]
    kc[bidx, slot] = k[:, tail]
    vc[bidx, slot] = v[:, tail]
    pc[bidx, slot] = p[:, tail]
    return kc, vc, pc


def gqa_cache_len(cfg: AttnConfig, s_max: int) -> int:
    return min(s_max, cfg.window) if cfg.window is not None else s_max


class GQA(nn.Module):
    def __init__(self, cfg: AttnConfig, dtype, init: ParamInit):
        super().__init__()
        d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.cfg = cfg
        self.q = init.dense((d, H * hd), dtype)
        self.k = init.dense((d, K * hd), dtype)
        self.v = init.dense((d, K * hd), dtype)
        self.o = init.dense((H * hd, d), dtype, fan_in=H * hd)

    def _qkv(self, x, positions):
        cfg = self.cfg
        B, S, _ = x.shape
        H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        # head-sharded layouts pinned at the reshape (the reference pins
        # them after it: left to propagation, GSPMD replicated whole
        # attention bodies)
        q = shardctx.view(torch.matmul(x, self.q), (B, S, H, hd), "qkv")
        k = shardctx.view(torch.matmul(x, self.k), (B, S, K, hd), "qkv")
        v = shardctx.view(torch.matmul(x, self.v), (B, S, K, hd), "qkv")
        if cfg.mrope_sections is not None:
            q = apply_mrope(q, positions, cfg.mrope_sections,
                            theta=cfg.rope_theta)
            k = apply_mrope(k, positions, cfg.mrope_sections,
                            theta=cfg.rope_theta)
        else:
            q = apply_rope(q, positions, theta=cfg.rope_theta)
            k = apply_rope(k, positions, theta=cfg.rope_theta)
        return q, k, v

    def _tpos(self, positions):
        """Positions the masks compare: M-RoPE masks on the t stream."""
        return (positions[..., 0] if self.cfg.mrope_sections is not None
                else positions)

    def attend_full(self, x, positions):
        cfg = self.cfg
        B, S, _ = x.shape
        q, k, v = self._qkv(x, positions)
        p = self._tpos(positions)
        out = shardctx.local("attend", chunked_attend, q, k, v, p, p,
                             causal=cfg.causal, window=cfg.window,
                             softcap=cfg.softcap)
        return torch.matmul(out.reshape(B, S, -1), self.o)

    def prefill_cache(self, x, positions, s_max: int) -> dict:
        """KV cache after consuming x. A windowed layer keeps its last W
        tokens in ring order (``ring_cache``)."""
        _, k, v = self._qkv(x, positions)
        p = self._tpos(positions)
        W = gqa_cache_len(self.cfg, s_max)
        if W == s_max:                       # full cache: slot = position
            kc, vc, pc = shardctx.local("prefill_cache", full_cache, k, v, p,
                                        s_max=s_max)
        else:
            kc, vc, pc = shardctx.local("prefill_cache", ring_cache, k, v, p,
                                        W=W)
        return dict(k=kc, v=vc, pos=pc)

    def attend_decode(self, x, positions, cache: dict, cache_index):
        """One-token decode with per-lane ``cache_index`` (B,): lane b
        writes slot ``cache_index[b] % W`` (== the index for a full
        cache)."""
        cfg = self.cfg
        B, S, _ = x.shape
        q, k, v = self._qkv(x, positions)
        p = self._tpos(positions)
        kc, vc, pc = cache["k"], cache["v"], cache["pos"]
        slot = (cache_index % kc.shape[1]).long()
        bidx = torch.arange(B, device=x.device)
        for c, new in ((kc, k[:, 0]), (vc, v[:, 0]), (pc, p[:, 0])):
            shardctx.local("cache_write", write_rows, c, slot, new,
                           lanes=bidx)
        out = shardctx.local("decode_attend", decode_attend, q, kc, vc, p, pc,
                             window=cfg.window, softcap=cfg.softcap)
        return torch.matmul(out.reshape(B, S, -1), self.o), cache


# ---------------------------------------------------------------------------
# block = mixer + ffn (+ norms)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockCfg:
    mixer: str                          # attn | mla | mamba | rwkv
    ffn: str = "mlp"                    # mlp | moe | none
    d_model: int = 0
    d_ff: int = 0
    attn: AttnConfig | None = None
    mla: MLAConfig | None = None
    moe: MoEConfig | None = None
    rwkv: ssm.RWKV6Config | None = None
    mamba: ssm.MambaConfig | None = None
    act: str = "silu"
    post_norm: bool = False             # gemma2 sandwich norms


class Block(nn.Module):
    def __init__(self, cfg: BlockCfg, dtype, init: ParamInit):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.norm1 = init.zeros((d,))
        if cfg.mixer == "attn":
            self.mixer = GQA(cfg.attn, dtype, init)
        elif cfg.mixer == "mla":
            self.mixer = MLA(cfg.mla, dtype, init)
        elif cfg.mixer == "mamba":
            self.mixer = ssm.Mamba(cfg.mamba, dtype, init)
        elif cfg.mixer == "rwkv":
            self.mixer = ssm.RWKV6(cfg.rwkv, dtype, init)
        else:
            raise ValueError(cfg.mixer)
        if cfg.ffn == "mlp":
            self.norm2 = init.zeros((d,))
            self.ffn = MLP(d, cfg.d_ff, dtype, init)
        elif cfg.ffn == "moe":
            self.norm2 = init.zeros((d,))
            self.ffn = MoE(cfg.moe, dtype, init)
        if cfg.post_norm:
            self.post1 = init.zeros((d,))
            if cfg.ffn != "none":
                self.post2 = init.zeros((d,))

    def _ffn(self, h, *, exact_moe: bool, with_aux: bool = False):
        """The FFN residual branch → (h, aux): aux is the MoE
        load-balancing loss of this block when asked for, else None."""
        cfg = self.cfg
        if cfg.ffn == "none":
            return h, None
        y = shardctx.shard(rms_norm(h, self.norm2), "block_in")
        aux = None
        if cfg.ffn == "moe":
            if with_aux:
                aux = moe_aux_loss(self.ffn, y)
            y = self.ffn(y, exact=exact_moe)
        else:
            y = self.ffn(y, act=cfg.act)
        # the row-parallel output's layout pinned before the residual add
        # (DTensor would otherwise pick it by cost, per op)
        y = shardctx.shard(y, "hidden")
        if cfg.post_norm:
            y = rms_norm(y, self.post2)
        return h + y, aux

    def _mix_out(self, h, y):
        y = shardctx.shard(y, "hidden")
        if self.cfg.post_norm:
            y = rms_norm(y, self.post1)
        return h + y

    def forward(self, h, positions, *, exact_moe: bool = False,
                with_aux: bool = False):
        """Full-sequence application (``block_apply_full``). With
        ``with_aux`` (the training path) it returns (h, aux), aux the MoE
        load-balancing loss (an f32 0 for a dense block)."""
        y = shardctx.shard(rms_norm(h, self.norm1), "block_in")
        if self.cfg.mixer in ("attn", "mla"):
            y = self.mixer.attend_full(y, positions)
        else:
            y, _ = self.mixer(y)
        h, aux = self._ffn(self._mix_out(h, y), exact_moe=exact_moe,
                           with_aux=with_aux)
        if not with_aux:
            return h
        return h, (aux if aux is not None
                   else torch.zeros((), device=h.device))

    def prefill(self, h, positions, s_max: int):
        """Full-sequence application that also returns the decode cache."""
        y = shardctx.shard(rms_norm(h, self.norm1), "block_in")
        if self.cfg.mixer in ("attn", "mla"):
            cache = self.mixer.prefill_cache(y, positions, s_max)
            y = self.mixer.attend_full(y, positions)
        else:
            y, cache = self.mixer(y)
        return self._ffn(self._mix_out(h, y), exact_moe=True)[0], cache

    def decode(self, h, positions, cache: dict, cache_index):
        """One-token decode with cache update."""
        y = shardctx.shard(rms_norm(h, self.norm1), "block_in")
        if self.cfg.mixer in ("attn", "mla"):
            y, cache = self.mixer.attend_decode(y, positions, cache,
                                                cache_index)
        else:
            y, cache = self.mixer(y, state=cache)
        return self._ffn(self._mix_out(h, y), exact_moe=True)[0], cache


def block_init_cache(cfg: BlockCfg, batch: int, s_max: int, dtype,
                     device) -> dict:
    """An empty decode cache."""
    kw = dict(device=device)
    if cfg.mixer == "attn":
        a = cfg.attn
        W = gqa_cache_len(a, s_max)
        return dict(
            k=torch.zeros((batch, W, a.n_kv_heads, a.head_dim), dtype=dtype,
                          **kw),
            v=torch.zeros((batch, W, a.n_kv_heads, a.head_dim), dtype=dtype,
                          **kw),
            pos=torch.full((batch, W), -1, dtype=torch.int32, **kw))
    if cfg.mixer == "mla":
        return dict(lat=torch.zeros((batch, s_max, cfg.mla.latent_dim),
                                    dtype=dtype, **kw),
                    pos=torch.full((batch, s_max), -1, dtype=torch.int32,
                                   **kw))
    if cfg.mixer == "mamba":
        m = cfg.mamba
        return dict(h=torch.zeros((batch, m.d_inner, m.d_state), **kw),
                    conv=torch.zeros((batch, m.d_conv - 1, m.d_inner),
                                     dtype=dtype, **kw))
    r = cfg.rwkv
    return dict(s=torch.zeros((batch, r.n_heads, r.head_dim, r.head_dim),
                              **kw),
                shift=torch.zeros((batch, r.d_model), dtype=dtype, **kw))
