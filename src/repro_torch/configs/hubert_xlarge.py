"""hubert-xlarge [audio] — encoder-only, w2v2 arch [arXiv:2106.07447;
unverified].

48L d_model=1280 16H (MHA: kv=16) d_ff=5120 vocab=504 (masked-prediction
cluster targets). The conv waveform frontend is a STUB per the assignment:
input_specs() provides precomputed frame embeddings (width 512). No decode
step (encoder-only) — decode shapes are skipped.
"""
from repro_torch.configs._builders import gqa_block
from repro_torch.configs.registry import ArchSpec
from repro_torch.models.model import ModelConfig


def _model(n_layers, d_model, n_heads, head_dim, d_ff, vocab, frontend,
           name) -> ModelConfig:
    blk = gqa_block(d_model=d_model, n_heads=n_heads, n_kv_heads=n_heads,
                    head_dim=head_dim, d_ff=d_ff, causal=False, act="gelu")
    return ModelConfig(
        name=name, n_layers=n_layers, d_model=d_model, vocab=vocab,
        period=(blk,), input_kind="embeddings", frontend_dim=frontend,
        encoder_only=True)


def spec() -> ArchSpec:
    model = _model(48, 1280, 16, 80, 5120, 504, 512, "hubert-xlarge")
    smoke = _model(2, 64, 4, 16, 128, 32, 24, "hubert-smoke")
    return ArchSpec(arch_id="hubert_xlarge", family="audio", model=model,
                    smoke=smoke, subquadratic=False,
                    source="[arXiv:2106.07447; unverified]",
                    notes="encoder-only; audio frontend stubbed (frames in)")
