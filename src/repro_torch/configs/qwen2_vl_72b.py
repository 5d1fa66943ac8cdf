"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064; head_dim=128;
M-RoPE sections (16, 24, 24) over (t, h, w) position streams. The vision
frontend is a STUB per the assignment: input_specs() provides precomputed
patch embeddings (width 1280, the ViT output), projected by ``in_proj``;
decode consumes text tokens through the embedding table.
"""
from repro_torch.configs._builders import gqa_block
from repro_torch.configs.registry import ArchSpec
from repro_torch.models.model import ModelConfig


def _model(n_layers, d_model, n_heads, n_kv, head_dim, d_ff, vocab,
           frontend, sections, name) -> ModelConfig:
    blk = gqa_block(d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
                    head_dim=head_dim, d_ff=d_ff, rope_theta=1e6,
                    mrope=sections)
    return ModelConfig(
        name=name, n_layers=n_layers, d_model=d_model, vocab=vocab,
        period=(blk,), input_kind="embeddings", frontend_dim=frontend,
        pos_dims=3)


def spec() -> ArchSpec:
    model = _model(80, 8192, 64, 8, 128, 29568, 152064, 1280, (16, 24, 24),
                   "qwen2-vl-72b")
    smoke = _model(2, 64, 4, 2, 16, 128, 256, 32, (2, 3, 3),
                   "qwen2-vl-smoke")
    return ArchSpec(arch_id="qwen2_vl_72b", family="vlm", model=model,
                    smoke=smoke, subquadratic=False,
                    source="[arXiv:2409.12191; hf]",
                    notes="vision frontend stubbed: patch embeddings in")
