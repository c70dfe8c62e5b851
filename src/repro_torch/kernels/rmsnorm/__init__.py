from repro_torch.kernels.rmsnorm.kernel import (LAUNCHES, LAUNCHES_BWD_DW,
                                                LAUNCHES_BWD_DX)
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import (rmsnorm_bwd_dw_ref,
                                             rmsnorm_bwd_dx_ref,
                                             rmsnorm_fwd_ref, rmsnorm_ref)

__all__ = ["LAUNCHES", "LAUNCHES_BWD_DW", "LAUNCHES_BWD_DX", "rmsnorm",
           "rmsnorm_bwd_dw_ref", "rmsnorm_bwd_dx_ref", "rmsnorm_fwd_ref",
           "rmsnorm_ref"]
