"""llama3-405b [dense] — GQA 128k vocab [arXiv:2407.21783; unverified].

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
"""
from repro_torch.configs._builders import dense_lm
from repro_torch.configs.registry import ArchSpec


def spec() -> ArchSpec:
    model = dense_lm(
        "llama3-405b", n_layers=126, d_model=16384, n_heads=128,
        n_kv_heads=8, d_ff=53248, vocab=128256, head_dim=128,
        rope_theta=500_000.0)
    smoke = dense_lm(
        "llama3-smoke", n_layers=3, d_model=96, n_heads=6, n_kv_heads=2,
        d_ff=256, vocab=256, head_dim=16, rope_theta=500_000.0)
    return ArchSpec(arch_id="llama3_405b", family="dense", model=model,
                    smoke=smoke, subquadratic=False,
                    source="[arXiv:2407.21783; unverified]")
