from repro_torch.core.apps.pagerank import (IncrementalPageRank,
                                           pagerank_edge_weights)
from repro_torch.core.apps.sssp import SSSP

__all__ = ["SSSP", "IncrementalPageRank", "pagerank_edge_weights"]
