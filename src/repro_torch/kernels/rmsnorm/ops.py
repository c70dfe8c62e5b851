"""Dispatch for rmsnorm, differentiable.

impl: "auto" | "ref".

- "auto" runs ``RMSNorm``, a ``torch.autograd.Function`` (the
  counterpart of the JAX ``custom_vjp``), where a gradient is wanted:
  its forward keeps the per-row rstd and saves (x, w, rstd); its
  backward returns dx in x's dtype and dw in w's dtype.  Without a
  gradient to take (serving) the forward runs alone, y only, with no
  Function around it.  On CUDA tensors the forward, dx and dw are Triton
  kernels — a CUDA tensor launches them or raises, never the plain
  path; on CPU tensors the same code runs the plain forward and the
  plain backward functions.
- "ref" runs the plain forward on any device and leaves its gradient to
  autograd: the independent plain path the kernels are held against.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import (rmsnorm_bwd_dw,
                                                rmsnorm_bwd_dx, rmsnorm_fwd)
from repro_torch.kernels.rmsnorm.ref import (rmsnorm_bwd_dw_ref,
                                             rmsnorm_bwd_dx_ref,
                                             rmsnorm_fwd_ref, rmsnorm_ref)


class RMSNorm(torch.autograd.Function):
    """x (n, d), w (d,) -> y (n, d)."""

    @staticmethod
    def forward(ctx, x, w, eps):
        if x.is_cuda:
            y, rstd = rmsnorm_fwd(x, w, eps=eps, save_rstd=True)
        else:
            y, rstd = rmsnorm_fwd_ref(x, w, eps)
        ctx.save_for_backward(x, w, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, rstd = ctx.saved_tensors
        if dy.stride(-1) != 1:
            dy = dy.contiguous()
        if x.is_cuda:
            dx = rmsnorm_bwd_dx(x, w, dy, rstd)
            dw = rmsnorm_bwd_dw(x, dy, rstd)
        else:
            dx = rmsnorm_bwd_dx_ref(x, w, dy, rstd)
            dw = rmsnorm_bwd_dw_ref(x, dy, rstd)
        return dx.to(x.dtype), dw.to(w.dtype), None


def rmsnorm(x, w, *, eps=1e-6, impl="auto"):
    """x (..., d); w (d,) -> rmsnorm(x) * w in x.dtype."""
    if impl == "ref":
        return rmsnorm_ref(x, w, eps)
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r}")
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        y = RMSNorm.apply(x, w, eps)
    elif x.is_cuda:
        y = rmsnorm_fwd(x, w, eps=eps)
    else:
        y = rmsnorm_ref(x, w, eps)
    return y.reshape(shape)
