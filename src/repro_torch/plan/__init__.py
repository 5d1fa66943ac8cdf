"""Planning (port of ``repro.plan``): LSH selectivity estimation, the
cost table the engine calibrates from finished joins, and the
``JoinPlanner`` that combines them into sticky ``JoinPlan``s."""
from repro_torch.plan.cost import CostEntry, CostTable
from repro_torch.plan.estimator import (MERGE_CAP_FLOOR, BandEstimate,
                                        LshEstimator)
from repro_torch.plan.planner import JoinPlan, JoinPlanner, PlanError

__all__ = [
    "BandEstimate", "CostEntry", "CostTable", "JoinPlan", "JoinPlanner",
    "LshEstimator", "MERGE_CAP_FLOOR", "PlanError",
]
