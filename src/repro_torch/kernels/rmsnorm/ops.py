"""Dispatch for rmsnorm: the Triton kernel on a CUDA tensor, the plain
version on a CPU tensor.

impl: "auto" (kernel on CUDA, plain on CPU) | "ref" (the plain version
on any device).  A CUDA tensor under "auto" launches the kernel or
raises — never the plain path.
"""
from __future__ import annotations

from repro_torch.kernels.rmsnorm.kernel import rmsnorm_fwd
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm(x, w, *, eps=1e-6, impl="auto"):
    """x (..., d); w (d,) -> rmsnorm(x) * w in x.dtype."""
    if impl == "ref":
        return rmsnorm_ref(x, w, eps)
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r}")
    if not x.is_cuda:
        return rmsnorm_ref(x, w, eps)
    shape = x.shape
    y = rmsnorm_fwd(x.reshape(-1, shape[-1]), w, eps=eps)
    return y.reshape(shape)
