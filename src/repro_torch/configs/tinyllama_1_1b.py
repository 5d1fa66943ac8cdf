"""tinyllama-1.1b [dense] — llama2-arch small [arXiv:2401.02385; hf].

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
"""
from repro_torch.configs._builders import dense_lm
from repro_torch.configs.registry import ArchSpec


def spec() -> ArchSpec:
    model = dense_lm(
        "tinyllama-1.1b", n_layers=22, d_model=2048, n_heads=32,
        n_kv_heads=4, d_ff=5632, vocab=32000)
    smoke = dense_lm(
        "tinyllama-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256)
    return ArchSpec(arch_id="tinyllama_1_1b", family="dense", model=model,
                    smoke=smoke, subquadratic=False,
                    source="[arXiv:2401.02385; hf]")
