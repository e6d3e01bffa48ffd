"""The executor layer: one driver loop, the three engines as policies,
checkpointing as a hook."""

from repro_torch.exec.driver import ExecContext, ExecHook, run_engine
from repro_torch.exec.checkpoint import (CheckpointHook, checkpoint_key,
                                         drop_converged_lanes,
                                         require_monotone, validate_key)
from repro_torch.exec.iteration import (am_superstep, bsp_superstep,
                                        hybrid_iteration, init_hybrid)
from repro_torch.exec.local_phase import (fused_local_kernel, fused_step_fn,
                                          local_phase)
from repro_torch.exec.policy import (POLICIES, EnginePolicy, am_policy,
                                     bsp_policy, hybrid_policy, make_policy)

__all__ = [
    "run_engine", "ExecContext", "ExecHook", "EnginePolicy", "bsp_policy",
    "am_policy", "hybrid_policy", "POLICIES", "make_policy",
    "bsp_superstep", "am_superstep", "hybrid_iteration", "init_hybrid",
    "local_phase", "fused_step_fn", "fused_local_kernel",
    "CheckpointHook", "checkpoint_key", "validate_key", "require_monotone",
    "drop_converged_lanes",
]
