"""Roofline analysis of the LM dry run (port of ``repro.roofline``)."""
from repro_torch.roofline.analysis import (CollectiveRecord, CollectiveStats,
                                           Roofline, analyze,
                                           collective_stats, format_table,
                                           model_flops_estimate)
from repro_torch.roofline.hw import H100, HWSpec

__all__ = ["CollectiveRecord", "CollectiveStats", "Roofline", "analyze",
           "collective_stats", "format_table", "model_flops_estimate",
           "H100", "HWSpec"]
