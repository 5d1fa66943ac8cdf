"""gemma2-9b [dense] — local+global alternating, logit softcap
[arXiv:2408.00118; hf].

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000; head_dim=256;
period = (local SWA-4096, global); attn softcap 50, final softcap 30;
sandwich post-norms; tied embeddings scaled by sqrt(d). long_500k runs:
local layers decode from an O(4096) ring buffer, global layers keep the
full (sequence-sharded) KV — noted in the roofline.
"""
from repro_torch.configs._builders import gqa_block
from repro_torch.configs.registry import ArchSpec
from repro_torch.models.model import ModelConfig


def _model(n_layers, d_model, n_heads, n_kv, head_dim, d_ff, vocab, window,
           name) -> ModelConfig:
    kw = dict(d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
              head_dim=head_dim, d_ff=d_ff, softcap=50.0, post_norm=True,
              act="gelu")
    local = gqa_block(window=window, **kw)
    glob = gqa_block(window=None, **kw)
    return ModelConfig(
        name=name, n_layers=n_layers, d_model=d_model, vocab=vocab,
        period=(local, glob), tie_embeddings=True, final_softcap=30.0,
        emb_scale=True)


def spec() -> ArchSpec:
    model = _model(42, 3584, 16, 8, 256, 14336, 256000, 4096, "gemma2-9b")
    smoke = _model(4, 64, 4, 2, 16, 128, 256, 16, "gemma2-smoke")
    return ArchSpec(arch_id="gemma2_9b", family="dense", model=model,
                    smoke=smoke, subquadratic=True,
                    source="[arXiv:2408.00118; hf]",
                    notes="local:global=1:1 alternating; global layers at "
                          "500k keep full KV (sequence-sharded)")
