from repro_torch.kernels.quant_comm.kernel import (LAUNCHES_DEQUANT,
                                                   LAUNCHES_QUANT)
from repro_torch.kernels.quant_comm.ops import dequantize, quantize
from repro_torch.kernels.quant_comm.ref import dequantize_ref, quantize_ref

__all__ = ["LAUNCHES_DEQUANT", "LAUNCHES_QUANT", "dequantize",
           "dequantize_ref", "quantize", "quantize_ref"]
