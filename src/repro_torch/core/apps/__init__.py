from repro_torch.core.apps.bipartite_matching import BipartiteMatching
from repro_torch.core.apps.multi import (MultiSourceMonotone,
                                         PersonalizedPageRank, reachable,
                                         sources_digest)
from repro_torch.core.apps.pagerank import (IncrementalPageRank,
                                           pagerank_edge_weights)
from repro_torch.core.apps.random_walk import (RandomWalk,
                                              random_walk_edge_weights)
from repro_torch.core.apps.sssp import SSSP
from repro_torch.core.apps.wcc import WCC
from repro_torch.core.apps.widest_path import WidestPath

__all__ = ["SSSP", "IncrementalPageRank", "WCC", "BipartiteMatching",
           "WidestPath", "RandomWalk", "MultiSourceMonotone",
           "PersonalizedPageRank", "reachable", "sources_digest",
           "pagerank_edge_weights", "random_walk_edge_weights"]
