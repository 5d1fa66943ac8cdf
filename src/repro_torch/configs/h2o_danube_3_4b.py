"""h2o-danube-3-4b [dense] — llama+mistral mix, SWA [arXiv:2401.16818;
unverified].

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000; sliding-window
attention (window 4096) ⇒ sub-quadratic, long_500k runs with an O(window)
ring-buffer KV cache.
"""
from repro_torch.configs._builders import dense_lm
from repro_torch.configs.registry import ArchSpec


def spec() -> ArchSpec:
    model = dense_lm(
        "h2o-danube-3-4b", n_layers=24, d_model=3840, n_heads=32,
        n_kv_heads=8, d_ff=10240, vocab=32000, window=4096)
    smoke = dense_lm(
        "h2o-danube-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, window=16)
    return ArchSpec(arch_id="h2o_danube_3_4b", family="dense", model=model,
                    smoke=smoke, subquadratic=True,
                    source="[arXiv:2401.16818; unverified]",
                    notes="SWA window=4096; decode state O(window)")
