from repro_torch.kernels.ell_spmv.ops import ell_spmv, to_ell
from repro_torch.kernels.ell_spmv.ref import ell_spmv_ref

__all__ = ["ell_spmv", "to_ell", "ell_spmv_ref"]
