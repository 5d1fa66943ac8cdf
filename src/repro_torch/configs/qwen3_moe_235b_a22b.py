"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

94L d_model=4096 64H (GQA kv=4) d_ff=1536 (per expert) vocab=151936,
MoE 128e top-8 on every layer; head_dim=128.
"""
from repro_torch.configs._builders import gqa_block
from repro_torch.configs.registry import ArchSpec
from repro_torch.models.layers import MoEConfig
from repro_torch.models.model import ModelConfig


def _model(n_layers, d_model, n_heads, n_kv, head_dim, d_ff, vocab,
           n_experts, top_k, name) -> ModelConfig:
    moe = MoEConfig(n_experts=n_experts, top_k=top_k, d_model=d_model,
                    d_ff=d_ff)
    blk = gqa_block(d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
                    head_dim=head_dim, d_ff=d_ff, rope_theta=1e6,
                    ffn="moe", moe=moe)
    return ModelConfig(name=name, n_layers=n_layers, d_model=d_model,
                       vocab=vocab, period=(blk,))


def spec() -> ArchSpec:
    model = _model(94, 4096, 64, 4, 128, 1536, 151936, 128, 8,
                   "qwen3-moe-235b-a22b")
    smoke = _model(2, 64, 4, 2, 16, 96, 256, 4, 2, "qwen3-moe-smoke")
    return ArchSpec(arch_id="qwen3_moe_235b_a22b", family="moe", model=model,
                    smoke=smoke, subquadratic=False,
                    source="[hf:Qwen/Qwen3-30B-A3B; hf]")
