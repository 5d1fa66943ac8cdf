"""Planning (port of ``repro.plan``): LSH selectivity estimation and the
cost table the engine calibrates from finished joins. ``JoinPlanner``
arrives with the plan slice (ROADMAP Queue A)."""
from repro_torch.plan.cost import CostEntry, CostTable
from repro_torch.plan.estimator import BandEstimate, LshEstimator

__all__ = ["BandEstimate", "CostEntry", "CostTable", "LshEstimator"]
