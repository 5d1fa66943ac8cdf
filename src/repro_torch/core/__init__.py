"""Core vector-join library (the paper's contribution), in PyTorch."""
from repro_torch.core.graph import build_index, build_merged_index, exact_knn
from repro_torch.core.join import (cascade_join_pairs, exact_join_pairs,
                                   vector_join)
from repro_torch.core.ood import predict_ood
from repro_torch.core.types import (METHODS, NO_NODE, GraphIndex, JoinConfig,
                                    JoinResult, JoinStats, TraversalConfig,
                                    graph_index_from_numpy, recall)

__all__ = [
    "build_index", "build_merged_index", "exact_knn",
    "cascade_join_pairs", "exact_join_pairs", "vector_join", "predict_ood",
    "GraphIndex", "JoinConfig", "JoinResult", "JoinStats",
    "TraversalConfig", "recall", "METHODS", "NO_NODE",
    "graph_index_from_numpy",
]
