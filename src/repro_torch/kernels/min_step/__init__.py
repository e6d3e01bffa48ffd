from repro_torch.kernels.min_step.ops import fused_min_step
from repro_torch.kernels.min_step.ref import fused_min_step_ref

__all__ = ["fused_min_step", "fused_min_step_ref"]
