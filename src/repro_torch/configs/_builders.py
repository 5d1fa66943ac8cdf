"""Shared constructors for the per-arch config files."""
from __future__ import annotations

from repro_torch.models import ssm
from repro_torch.models.blocks import BlockCfg, MLAConfig
from repro_torch.models.layers import AttnConfig, MoEConfig
from repro_torch.models.model import ModelConfig


def gqa_block(*, d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
              d_ff: int, window: int | None = None,
              softcap: float | None = None, rope_theta: float = 10_000.0,
              causal: bool = True, mrope: tuple[int, ...] | None = None,
              ffn: str = "mlp", moe: MoEConfig | None = None,
              act: str = "silu", post_norm: bool = False) -> BlockCfg:
    return BlockCfg(
        mixer="attn", ffn=ffn, d_model=d_model, d_ff=d_ff, act=act,
        post_norm=post_norm, moe=moe,
        attn=AttnConfig(d_model=d_model, n_heads=n_heads,
                        n_kv_heads=n_kv_heads, head_dim=head_dim,
                        causal=causal, window=window, softcap=softcap,
                        rope_theta=rope_theta, mrope_sections=mrope))


def dense_lm(name: str, *, n_layers: int, d_model: int, n_heads: int,
             n_kv_heads: int, d_ff: int, vocab: int,
             head_dim: int | None = None, rope_theta: float = 10_000.0,
             window: int | None = None, **mc_kw) -> ModelConfig:
    head_dim = head_dim or d_model // n_heads
    blk = gqa_block(d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv_heads,
                    head_dim=head_dim, d_ff=d_ff, window=window,
                    rope_theta=rope_theta)
    return ModelConfig(name=name, n_layers=n_layers, d_model=d_model,
                       vocab=vocab, period=(blk,), **mc_kw)


def rwkv_block(*, d_model: int, n_heads: int, d_ff: int,
               decay_lora: int = 64, chunk: int = 64) -> BlockCfg:
    return BlockCfg(
        mixer="rwkv", ffn="mlp", d_model=d_model, d_ff=d_ff,
        rwkv=ssm.RWKV6Config(d_model=d_model, n_heads=n_heads,
                             decay_lora=decay_lora, chunk=chunk))


def mamba_block(*, d_model: int, d_ff: int, d_state: int = 16,
                d_conv: int = 4, expand: int = 2, chunk: int = 64,
                ffn: str = "mlp", moe: MoEConfig | None = None) -> BlockCfg:
    return BlockCfg(
        mixer="mamba", ffn=ffn, d_model=d_model, d_ff=d_ff, moe=moe,
        mamba=ssm.MambaConfig(d_model=d_model, d_state=d_state,
                              d_conv=d_conv, expand=expand, chunk=chunk))


def mla_block(*, d_model: int, n_heads: int, d_ff: int,
              q_lora_rank: int = 1536, kv_lora_rank: int = 512,
              qk_nope_dim: int = 128, qk_rope_dim: int = 64,
              v_dim: int = 128, ffn: str = "mlp",
              moe: MoEConfig | None = None) -> BlockCfg:
    return BlockCfg(
        mixer="mla", ffn=ffn, d_model=d_model, d_ff=d_ff, moe=moe,
        mla=MLAConfig(d_model=d_model, n_heads=n_heads,
                      q_lora_rank=q_lora_rank, kv_lora_rank=kv_lora_rank,
                      qk_nope_dim=qk_nope_dim, qk_rope_dim=qk_rope_dim,
                      v_dim=v_dim))
