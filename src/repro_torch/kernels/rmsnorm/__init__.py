from repro_torch.kernels.rmsnorm.kernel import LAUNCHES
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

__all__ = ["LAUNCHES", "rmsnorm", "rmsnorm_ref"]
