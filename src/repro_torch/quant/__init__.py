"""Compressed storage tiers of the port (``repro_torch.quant``)."""
from repro_torch.quant.cascade import (MATMUL_GUARD, TIERS_BY_MODE,
                                       FilterCascade, Int8Queries, Int8Tier,
                                       PdxTier, SketchQueries, SketchTier,
                                       build_cascade, build_tier_store,
                                       make_cascade)
from repro_torch.quant.pdx import (PdxQueries, PdxStore, build_pdx,
                                   pdx_queries, pdx_store_from_numpy)
from repro_torch.quant.sketch import (SketchStore, build_sketch,
                                      sketch_queries,
                                      sketch_store_from_numpy,
                                      sketch_survivors)
from repro_torch.quant.store import (QuantStore, build_store, dequantize,
                                     quantize_queries)

__all__ = ["MATMUL_GUARD", "TIERS_BY_MODE", "FilterCascade", "Int8Queries",
           "Int8Tier", "PdxTier", "SketchQueries", "SketchTier",
           "build_cascade", "build_tier_store", "make_cascade",
           "PdxQueries", "PdxStore", "build_pdx",
           "pdx_queries", "pdx_store_from_numpy", "SketchStore",
           "build_sketch", "sketch_queries", "sketch_store_from_numpy",
           "sketch_survivors",
           "QuantStore", "build_store", "dequantize", "quantize_queries"]
