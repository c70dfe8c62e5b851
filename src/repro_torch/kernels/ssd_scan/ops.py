"""Dispatch for the SSD chunk scan, differentiable (the contract of
``repro/kernels/ssd_scan/ops.py:ssd_scan``).

impl: "auto" | "ref".

- "auto" runs ``SSDScan``, a ``torch.autograd.Function`` (the
  counterpart of the JAX ``custom_vjp``), where a gradient is wanted:
  its forward saves each chunk's incoming state (O(l / chunk) memory),
  and its backward runs the reverse chunked recurrence in one pass from
  those states.  Without a gradient to take (serving) the forward runs
  alone.  On CUDA tensors the forward and the backward are kernels — a
  CUDA tensor launches them or raises, never the plain path; on CPU
  tensors the same code runs the plain forward and the plain backward.
- "ref" runs the model's plain chunked scan on any device and leaves its
  gradient to autograd (like the JAX "ref", it needs l to be a multiple
  of the chunk).

Sequence lengths that are not chunk multiples are padded with zero x,
a, B, C: zero x and B leave the carried state (so h_final) exact, the
padded y rows are sliced off, and they receive zero cotangents.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_bwd, ssd_scan_fwd
from repro_torch.kernels.ssd_scan.ref import ssd_bwd_ref, ssd_fwd_ref, ssd_ref


class SSDScan(torch.autograd.Function):
    """x (b,l,h,p), a (b,l,h) fp32, B/C (b,l,n), l a multiple of chunk ->
    (y (b,l,h,p), h_final (b,h,p,n) fp32)."""

    @staticmethod
    def forward(ctx, x, a, B, C, chunk):
        if x.is_cuda:
            y, hfin, hprev = ssd_scan_fwd(x, a, B, C, chunk=chunk,
                                          save_hprev=True)
        else:
            y, hfin, hprev = ssd_fwd_ref(x, a, B, C, chunk)
        ctx.save_for_backward(x, a, B, C, hprev)
        ctx.chunk = chunk
        return y, hfin

    @staticmethod
    def backward(ctx, dy, dhfin):
        x, a, B, C, hprev = ctx.saved_tensors
        if x.is_cuda:
            grads = ssd_scan_bwd(x, a, B, C, hprev, dy, dhfin,
                                 chunk=ctx.chunk)
        else:
            grads = ssd_bwd_ref(x, a, B, C, hprev, dy, dhfin, ctx.chunk)
        return (*grads, None)


def _pad_steps(t, target: int):
    if t.shape[1] == target:
        return t
    pad = [0, 0] * (t.dim() - 2) + [0, target - t.shape[1]]
    return F.pad(t, pad)


def ssd_scan(x, a, B, C, *, chunk=256, impl="auto"):
    """x (b,l,h,p); a (b,l,h) log-decay; B/C (b,l,n) -> (y (b,l,h,p) in
    x.dtype, h_final (b,h,p,n) fp32)."""
    if impl == "ref":
        return ssd_ref(x, a, B, C, chunk)
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r}")
    l = x.shape[1]
    c = min(chunk, l)
    l_p = -(-l // c) * c
    x, a, B, C = (_pad_steps(t, l_p).contiguous() for t in (x, a, B, C))
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, a, B, C)):
        y, hfin = SSDScan.apply(x, a, B, C, c)
    elif x.is_cuda:
        y, hfin = ssd_scan_fwd(x, a, B, C, chunk=c)
    else:
        y, hfin = ssd_fwd_ref(x, a, B, C, c)[:2]
    return y[:, :l], hfin
