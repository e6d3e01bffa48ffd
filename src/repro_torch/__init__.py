"""GraphHP on PyTorch + CUDA: the port of the JAX/Pallas package ``repro``.

The package mirrors ``repro``'s layout and names.  It imports ``torch`` and
never ``jax`` or ``repro``: what it needs of the reference's numpy-only
modules (partitioners, graph generators, ELL packers) it keeps as copies.
The three Pallas kernels are hand-written CUDA kernels under ``csrc/``,
built with ``nvcc`` for ``sm_90a`` at first use; on CPU tensors their
wrappers run the plain PyTorch versions.

``build_partitioned_graph`` -> ``run_hybrid`` (GraphHP), ``run_bsp``
(Hama) or ``run_am`` (AM-Hama), over the ELL kernels or the dense
gather/segment path, for every app of ``repro.core.apps``.  Entry points
place tensors on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from repro_torch.core.apps import (SSSP, WCC, BipartiteMatching,
                                   IncrementalPageRank, MultiSourceMonotone,
                                   PersonalizedPageRank, RandomWalk,
                                   WidestPath, pagerank_edge_weights,
                                   random_walk_edge_weights)
from repro_torch.core.engine_am import run_am
from repro_torch.core.engine_bsp import run_bsp
from repro_torch.core.engine_hybrid import run_hybrid
from repro_torch.core.graph import (PartitionedGraph, build_partitioned_graph,
                                    unpack_vertex)

__all__ = ["SSSP", "IncrementalPageRank", "WCC", "BipartiteMatching",
           "WidestPath", "RandomWalk", "MultiSourceMonotone",
           "PersonalizedPageRank", "pagerank_edge_weights",
           "random_walk_edge_weights", "run_bsp", "run_am", "run_hybrid",
           "PartitionedGraph", "build_partitioned_graph", "unpack_vertex"]
