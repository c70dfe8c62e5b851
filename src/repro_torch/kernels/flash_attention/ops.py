"""Dispatch for flash attention, differentiable.

The public layout is the JAX package's: q (b, h, sq, d), k/v
(b, kvh, skv, d).  impl: "auto" | "ref".

- "auto" runs ``FlashAttention``, a ``torch.autograd.Function`` (the
  counterpart of the JAX ``custom_vjp``), where a gradient is wanted.
  Its forward keeps the per-row logsumexp and saves (q, k, v, o, lse);
  its backward computes δ = rowsum(o·do) in fp32 in plain PyTorch, then
  dK/dV, then dQ.  Without a gradient to take (serving) the forward runs
  alone, o only, with no Function around it.  On CUDA tensors every
  step is a kernel — a CUDA tensor launches its kernels or raises,
  never the plain path; on CPU tensors the same code runs the plain
  forward and the plain backward functions.
- "ref" runs the plain forward on any device and leaves its gradient to
  autograd: the independent plain path the kernels are held against.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_fwd_ref,
                                                     attention_ref)


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, kv_len):
        kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
        if q.is_cuda:
            o, lse = flash_attention_fwd(q, k, v, save_lse=True, **kw)
        else:
            o, lse = attention_fwd_ref(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = (o.float() * do.float()).sum(dim=-1).contiguous()
        if q.is_cuda:
            dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                             **ctx.kw)
            dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **ctx.kw)
        else:
            dq, dk, dv = attention_bwd_ref(q, k, v, do, lse, delta,
                                           **ctx.kw)
            dq, dk, dv = dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, impl="auto", q_offset=None,
                    kv_len=None):
    """``q_offset``: absolute position of q[0] among the keys (default
    skv - sq, end-aligned); ``kv_len``: keys at positions >= kv_len are
    masked (padding)."""
    if impl == "ref":
        return attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                             kv_len=kv_len)
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, q_offset, kv_len)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    return flash_attention_fwd(q, k, v, **kw) if q.is_cuda else \
        attention_ref(q, k, v, **kw)
