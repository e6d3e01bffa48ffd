"""The paper's own workload as a dry-runnable 'architecture': the GraphHP
hybrid engine over a partitioned synthetic road-network graph, distributed
with shard_map over the production mesh (one partition block per device)."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class GraphHPConfig:
    name: str = "graphhp-paper"
    family: str = "graph"
    # per-device partition block sizes (padded static shapes)
    n_partitions: int = 256            # one per single-pod device
    vertices_per_partition: int = 16_384
    edges_per_partition: int = 65_536
    exports_per_partition: int = 2_048
    halo_per_partition: int = 2_048
    app: str = "sssp"
    source: str = "GraphHP (CS.DC 2017) §7"


CONFIG = GraphHPConfig()
SMOKE = dataclasses.replace(
    CONFIG, name="graphhp-smoke", n_partitions=4, vertices_per_partition=64,
    edges_per_partition=256, exports_per_partition=32, halo_per_partition=32)
