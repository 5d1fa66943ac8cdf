"""Persistent join serving layer (engine.JoinEngine) and its wave runners."""
from repro_torch.engine.engine import JoinEngine
from repro_torch.engine.waves import (run_mi_join, run_search_join,
                                      run_search_wave)

__all__ = ["JoinEngine", "run_mi_join", "run_search_join",
           "run_search_wave"]
