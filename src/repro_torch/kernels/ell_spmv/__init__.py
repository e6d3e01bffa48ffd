from repro_torch.kernels.ell_spmv.ops import ell_spmv, to_ell
from repro_torch.kernels.ell_spmv.plan import EllBlockPlan, ell_block_plan
from repro_torch.kernels.ell_spmv.ref import ell_spmv_ref

__all__ = ["ell_spmv", "to_ell", "ell_spmv_ref", "EllBlockPlan",
           "ell_block_plan"]
