"""Compressed storage tiers of the port (``repro_torch.quant``)."""
from repro_torch.quant.cascade import (MATMUL_GUARD, TIERS_BY_MODE,
                                       FilterCascade, Int8Queries, Int8Tier,
                                       build_cascade, build_tier_store,
                                       make_cascade, matmul_guard)
from repro_torch.quant.store import (QuantStore, build_store, dequantize,
                                     quantize_queries)

__all__ = ["MATMUL_GUARD", "TIERS_BY_MODE", "FilterCascade", "Int8Queries",
           "Int8Tier", "build_cascade", "build_tier_store", "make_cascade",
           "matmul_guard", "QuantStore", "build_store", "dequantize",
           "quantize_queries"]
