"""Fault tolerance: checkpointed hybrid runs that survive a worker loss
(``run_hybrid_ft``), the heartbeat monitor and fault injector that drive
recovery, elastic k -> k' resize, and straggler flags."""

from repro_torch.ft.heartbeat import HeartbeatMonitor, WorkerState
from repro_torch.ft.elastic import (ElasticPlan, partition_owners,
                                    replan_partitions, resize_labels,
                                    reshard_vertex_tree)
from repro_torch.ft.inject import FaultInjector, FaultPlan
from repro_torch.ft.straggler import (ShardFlag, StragglerMitigator,
                                      flag_slow_shards)
from repro_torch.ft.driver import (FTRunResult, RecoveryEvent,
                                   checkpoint_key, elastic_restore,
                                   reshard_checkpoint_arrays, run_hybrid_ft)
__all__ = ["HeartbeatMonitor", "WorkerState", "ElasticPlan",
           "partition_owners", "replan_partitions", "resize_labels",
           "reshard_vertex_tree", "FaultInjector", "FaultPlan",
           "ShardFlag", "StragglerMitigator", "flag_slow_shards",
           "FTRunResult", "RecoveryEvent", "checkpoint_key",
           "elastic_restore", "reshard_checkpoint_arrays", "run_hybrid_ft"]
