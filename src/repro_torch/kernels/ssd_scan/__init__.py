from repro_torch.kernels.ssd_scan.kernel import LAUNCHES, LAUNCHES_BWD
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import (ssd_bwd_ref, ssd_fwd_ref,
                                              ssd_quadratic_ref, ssd_ref)

__all__ = ["LAUNCHES", "LAUNCHES_BWD", "ssd_bwd_ref", "ssd_fwd_ref",
           "ssd_quadratic_ref", "ssd_ref", "ssd_scan"]
