from repro_torch.core.graph import (EllSlice, PartitionedGraph,
                                    build_partitioned_graph, unpack_vertex)
from repro_torch.core.vertex_program import Channel, StepInfo, VertexProgram
from repro_torch.core.runtime import Counters, EngineState
from repro_torch.core.engine_am import run_am
from repro_torch.core.engine_bsp import run_bsp
from repro_torch.core.engine_hybrid import run_hybrid

__all__ = [
    "EllSlice", "PartitionedGraph", "build_partitioned_graph",
    "unpack_vertex", "Channel", "StepInfo", "VertexProgram", "Counters",
    "EngineState", "run_bsp", "run_am", "run_hybrid",
]
