"""Dispatch for MoE router top-k gating, differentiable (the contract of
``repro/kernels/topk_gating/ops.py:topk_gating``).

impl: "auto" | "ref".

- "auto" runs ``TopKGating``, a ``torch.autograd.Function`` (the
  counterpart of the JAX ``custom_vjp``), where a gradient is wanted.
  Its forward saves (logits, experts) only, ``experts`` is marked
  non-differentiable, and its backward emits dlogits in one pass from
  the weights' cotangent.  Without a gradient to take (serving) the
  forward runs alone, with no Function around it, and a CUDA tensor
  goes to the kernel's wrapper in the fewest Python steps.  On CUDA
  tensors the forward and the backward are kernels — a CUDA tensor
  launches them or raises, never the plain path; on CPU tensors the
  same code runs the plain forward and the plain backward functions.
- "ref" runs the JAX oracle's plain version on any device and leaves
  its gradient to autograd.

Any T is taken: the kernels need no row padding.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.topk_gating.kernel import (topk_gating_bwd,
                                                    topk_gating_fwd)
from repro_torch.kernels.topk_gating.ref import (topk_gating_bwd_ref,
                                                 topk_gating_fwd_ref,
                                                 topk_gating_ref)


class TopKGating(torch.autograd.Function):
    """logits (T, E) -> (weights (T, k) fp32, experts (T, k) int32)."""

    @staticmethod
    def forward(ctx, logits, k, renorm):
        if logits.is_cuda:
            w, experts = topk_gating_fwd(logits, k, renorm)
        else:
            w, experts = topk_gating_fwd_ref(logits, k, renorm)
        ctx.mark_non_differentiable(experts)
        ctx.save_for_backward(logits, experts)
        ctx.k, ctx.renorm = k, renorm
        return w, experts

    @staticmethod
    def backward(ctx, dw, _dexperts):
        logits, experts = ctx.saved_tensors
        bwd = topk_gating_bwd if logits.is_cuda else topk_gating_bwd_ref
        # dw is fp32 (the weights' dtype) but may be a broadcast view (the
        # gradient of a sum), and the kernel reads it densely
        return bwd(logits, experts, dw.contiguous(), ctx.k, ctx.renorm), \
            None, None


def topk_gating(logits, *, k: int, renorm=True, impl="auto"):
    """logits (T, E) -> (weights (T, k) fp32, experts (T, k) int32): the
    k most probable experts of softmax(logits) (the lower index first
    among equals), weights renormalised to sum 1 with ``renorm``."""
    if impl == "auto" and logits.is_cuda and not (
            logits.requires_grad and torch.is_grad_enabled()):
        return topk_gating_fwd(logits, k, renorm)  # serving: the kernel
    if impl == "ref":
        return topk_gating_ref(logits, k, renorm)
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r}")
    if torch.is_grad_enabled() and logits.requires_grad:
        return TopKGating.apply(logits, k, renorm)
    return topk_gating_fwd_ref(logits, k, renorm)
