"""Dispatch for the int8 wire format's quantize / dequantize (the
contract of ``repro/kernels/quant_comm/ops.py``: x (n,) with
n % 256 == 0, int8 codes, fp32 scales per 256-element block).

impl: "auto" | "ref".

- "auto" launches the kernel on a CUDA tensor and runs the plain version
  on a CPU tensor, chosen by where the tensor lies: a CUDA tensor
  launches its kernel or raises, never the plain path.
- "ref" runs the plain version on any device.

Both give the same bits (``ref.py`` says which arithmetic).  Nothing is
differentiated through them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quant_comm.kernel import (dequantize_fwd,
                                                   quantize_fwd)
from repro_torch.kernels.quant_comm.ref import dequantize_ref, quantize_ref


def _impl(impl, t):
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    return impl == "auto" and t.is_cuda


def quantize(x, *, impl="auto"):
    """x (n,) float, n % 256 == 0 -> (q int8 (n,), scales fp32
    (n / 256,))."""
    return quantize_fwd(x) if _impl(impl, x) else quantize_ref(x)


def dequantize(q, s, *, out_dtype=torch.float32, impl="auto"):
    """q (n,) int8, scales (n / 256,) fp32 -> q · s (n,) in
    ``out_dtype``."""
    if _impl(impl, q):
        return dequantize_fwd(q, s, out_dtype)
    return dequantize_ref(q, s, out_dtype)
