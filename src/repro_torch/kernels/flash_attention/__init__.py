from repro_torch.kernels.flash_attention.kernel import (LAUNCHES,
                                                        LAUNCHES_BWD_DKV,
                                                        LAUNCHES_BWD_DQ)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_fwd_ref,
                                                     attention_ref)

__all__ = ["LAUNCHES", "LAUNCHES_BWD_DKV", "LAUNCHES_BWD_DQ",
           "attention_bwd_ref", "attention_fwd_ref", "attention_ref",
           "flash_attention"]
