"""The executor layer: one driver loop, the hybrid engine as a policy."""

from repro_torch.exec.driver import ExecContext, ExecHook, run_engine
from repro_torch.exec.iteration import hybrid_iteration, init_hybrid
from repro_torch.exec.local_phase import (fused_local_kernel, fused_step_fn,
                                          local_phase)
from repro_torch.exec.policy import EnginePolicy, hybrid_policy

__all__ = [
    "run_engine", "ExecContext", "ExecHook", "EnginePolicy", "hybrid_policy",
    "hybrid_iteration", "init_hybrid", "local_phase", "fused_step_fn",
    "fused_local_kernel",
]
