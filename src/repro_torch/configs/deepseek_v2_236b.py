"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared+160 routed top-6
[arXiv:2405.04434; hf].

60L d_model=5120 128H (MLA; spec lists GQA kv=128 ≡ MHA with latent
compression) d_ff=1536 (per routed expert) vocab=102400; MoE 160e top-6
plus 2 shared experts; q_lora=1536, kv_lora=512, qk = 128 nope + 64 rope,
v_dim=128. The decode cache is the 576-wide latent per token (the point of
MLA), attended in absorbed (MQA-form) space.
"""
from repro_torch.configs._builders import mla_block
from repro_torch.configs.registry import ArchSpec
from repro_torch.models.layers import MoEConfig
from repro_torch.models.model import ModelConfig


def _model(n_layers, d_model, n_heads, d_ff, vocab, n_experts, top_k,
           n_shared, q_lora, kv_lora, nope, rope, v_dim, name) -> ModelConfig:
    moe = MoEConfig(n_experts=n_experts, top_k=top_k, d_model=d_model,
                    d_ff=d_ff, n_shared=n_shared)
    blk = mla_block(d_model=d_model, n_heads=n_heads, d_ff=d_ff,
                    q_lora_rank=q_lora, kv_lora_rank=kv_lora,
                    qk_nope_dim=nope, qk_rope_dim=rope, v_dim=v_dim,
                    ffn="moe", moe=moe)
    return ModelConfig(name=name, n_layers=n_layers, d_model=d_model,
                       vocab=vocab, period=(blk,))


def spec() -> ArchSpec:
    model = _model(60, 5120, 128, 1536, 102400, 160, 6, 2,
                   1536, 512, 128, 64, 128, "deepseek-v2-236b")
    smoke = _model(2, 64, 4, 96, 256, 4, 2, 1, 32, 16, 16, 8, 16,
                   "deepseek-v2-smoke")
    return ArchSpec(arch_id="deepseek_v2_236b", family="moe", model=model,
                    smoke=smoke, subquadratic=False,
                    source="[arXiv:2405.04434; hf]",
                    notes="MLA latent cache = 576 B/token (bf16 ⇒ 1152)")
