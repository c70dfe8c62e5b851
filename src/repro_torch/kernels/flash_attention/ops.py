"""Dispatch for flash attention (forward only; the backward kernels come
with the training slice).

The public layout is the JAX package's: q (b, h, sq, d), k/v
(b, kvh, skv, d).  impl: "auto" (kernel on CUDA, plain on CPU) | "ref"
(the plain version anywhere).  A CUDA tensor under "auto" launches the
kernel or raises.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import attention_ref


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
    if not q.is_cuda:
        return attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                             kv_len=kv_len)
    return flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset,
                               kv_len=kv_len)
