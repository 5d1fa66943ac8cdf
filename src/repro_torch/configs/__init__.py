"""Vector-join presets and engine specs (``configs.vectorjoin``)."""
from repro_torch.configs.vectorjoin import (ENGINE_PRESETS, PRESETS,
                                            EngineSpec, make_engine, preset)

__all__ = ["ENGINE_PRESETS", "PRESETS", "EngineSpec", "make_engine",
           "preset"]
