from repro_torch.kernels.topk_gating.kernel import LAUNCHES, LAUNCHES_BWD
from repro_torch.kernels.topk_gating.ops import topk_gating
from repro_torch.kernels.topk_gating.ref import (topk_gating_bwd_ref,
                                                 topk_gating_fwd_ref,
                                                 topk_gating_ref)

__all__ = ["LAUNCHES", "LAUNCHES_BWD", "topk_gating", "topk_gating_bwd_ref",
           "topk_gating_fwd_ref", "topk_gating_ref"]
