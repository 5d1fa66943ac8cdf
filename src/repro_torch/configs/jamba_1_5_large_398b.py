"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887; hf].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536; MoE 16e top-2 on
every other layer; period of 8 = (attn, mamba×7) with MoE at the odd
positions. Mamba: d_state=16, d_conv=4, expand=2. Hybrid ⇒ long_500k runs
(O(1) mamba states; full sequence-sharded KV on the 1-in-8 attn layers).
"""
from repro_torch.configs._builders import gqa_block, mamba_block
from repro_torch.configs.registry import ArchSpec
from repro_torch.models.layers import MoEConfig
from repro_torch.models.model import ModelConfig


def _model(n_layers, d_model, n_heads, n_kv, head_dim, d_ff, vocab,
           n_experts, top_k, d_state, name) -> ModelConfig:
    moe = MoEConfig(n_experts=n_experts, top_k=top_k, d_model=d_model,
                    d_ff=d_ff)
    attn = gqa_block(d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
                     head_dim=head_dim, d_ff=d_ff)
    mam = lambda ffn: mamba_block(d_model=d_model, d_ff=d_ff,
                                  d_state=d_state, ffn=ffn,
                                  moe=moe if ffn == "moe" else None)
    period = (attn, mam("moe"), mam("mlp"), mam("moe"),
              mam("mlp"), mam("moe"), mam("mlp"), mam("moe"))
    return ModelConfig(name=name, n_layers=n_layers, d_model=d_model,
                       vocab=vocab, period=period)


def spec() -> ArchSpec:
    model = _model(72, 8192, 64, 8, 128, 24576, 65536, 16, 2, 16,
                   "jamba-1.5-large-398b")
    smoke = _model(8, 64, 4, 2, 16, 128, 256, 4, 2, 4, "jamba-smoke")
    return ArchSpec(arch_id="jamba_1_5_large_398b", family="hybrid",
                    model=model, smoke=smoke, subquadratic=True,
                    source="[arXiv:2403.19887; hf]",
                    notes="attn:mamba=1:7; MoE every other layer")
