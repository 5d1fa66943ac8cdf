"""rwkv6-7b [ssm] — Finch, data-dependent decay [arXiv:2404.05892; hf].

32L d_model=4096 (attention-free) d_ff=14336 vocab=65536; 64 heads of
dim 64 in the wkv mixer; low-rank (64) data-dependent decay. O(1) decode
state ⇒ long_500k runs natively.
"""
from repro_torch.configs._builders import rwkv_block
from repro_torch.configs.registry import ArchSpec
from repro_torch.models.model import ModelConfig


def _model(n_layers, d_model, n_heads, d_ff, vocab, decay_lora, name
           ) -> ModelConfig:
    blk = rwkv_block(d_model=d_model, n_heads=n_heads, d_ff=d_ff,
                     decay_lora=decay_lora)
    return ModelConfig(name=name, n_layers=n_layers, d_model=d_model,
                       vocab=vocab, period=(blk,))


def spec() -> ArchSpec:
    model = _model(32, 4096, 64, 14336, 65536, 64, "rwkv6-7b")
    smoke = _model(2, 64, 4, 128, 256, 8, "rwkv6-smoke")
    return ArchSpec(arch_id="rwkv6_7b", family="ssm", model=model,
                    smoke=smoke, subquadratic=True,
                    source="[arXiv:2404.05892; hf]",
                    notes="attn-free; decode state O(H*hd^2) per layer")
