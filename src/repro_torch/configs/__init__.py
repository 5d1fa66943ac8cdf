"""Config registry: the 10 assigned architectures (``configs.registry``)
and the vector-join presets and engine specs (``configs.vectorjoin``)."""
from repro_torch.configs.registry import (ARCH_IDS, SHAPES, ArchSpec,
                                          ShapeSpec, all_specs, cells, get,
                                          input_specs, supported)
from repro_torch.configs.vectorjoin import (ENGINE_PRESETS, PRESETS,
                                            EngineSpec, make_engine, preset)

__all__ = ["ARCH_IDS", "SHAPES", "ArchSpec", "ShapeSpec", "all_specs",
           "cells", "get", "input_specs", "supported", "ENGINE_PRESETS", "PRESETS",
           "EngineSpec", "make_engine", "preset"]
