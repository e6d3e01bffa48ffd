from repro_torch.kernels.pr_step.ops import fused_pr_step
from repro_torch.kernels.pr_step.ref import fused_pr_step_ref

__all__ = ["fused_pr_step", "fused_pr_step_ref"]
