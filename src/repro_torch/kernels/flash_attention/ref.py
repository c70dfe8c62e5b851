"""Plain PyTorch versions of the flash-attention kernels: the forward
(with its per-row logsumexp) and the backward.

Unlike the JAX package's ``impl="ref"`` path (which always end-aligns),
these honour ``q_offset`` and ``kv_len`` exactly as the kernels do, and
— like the kernels — give zero rows for queries that see no key.  The
backward is written as the TPU kernels' formulas, not as autograd of
the forward: p = exp(s − lse) recomputed from the saved logsumexp,
masked to exactly 0, and ds = p·(dp − δ)·scale with δ = rowsum(o·do).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _setup(q, k, causal, q_offset, kv_len):
    """The masked fp32 scores s (b, h, sq, skv), the valid mask (sq, skv)
    and the GQA group size."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if q_offset is None:
        q_offset = skv - sq
    kv_len = skv if kv_len is None else kv_len
    kf = k.float().repeat_interleave(h // kvh, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * (d ** -0.5)
    kpos = torch.arange(skv, device=q.device)
    valid = (kpos < kv_len)[None, :].expand(sq, skv)
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        valid = valid & (kpos[None, :] <= qpos[:, None])
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    return s, valid, h // kvh


def attention_ref(q, k, v, *, causal=True, q_offset=None, kv_len=None):
    """q (b, h, sq, d); k/v (b, kvh, skv, d) -> (b, h, sq, d) in q.dtype,
    fp32 softmax (the plain path, differentiable by autograd)."""
    s, valid, group = _setup(q, k, causal, q_offset, kv_len)
    w = torch.softmax(s, dim=-1) * valid
    vf = v.float().repeat_interleave(group, dim=1)
    return torch.einsum("bhqk,bhkd->bhqd", w, vf).to(q.dtype)


def attention_fwd_ref(q, k, v, *, causal=True, q_offset=None, kv_len=None):
    """``attention_ref`` and the per-row logsumexp (b, h, sq) fp32 the
    backward needs (about -1e30 for a row that sees no key)."""
    o = attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                      kv_len=kv_len)
    s, _, _ = _setup(q, k, causal, q_offset, kv_len)
    return o, torch.logsumexp(s, dim=-1)


def attention_bwd_ref(q, k, v, do, lse, delta, *, causal=True,
                      q_offset=None, kv_len=None):
    """dq (b, h, sq, d), dk and dv (b, kvh, skv, d), all fp32, from the
    forward's ``lse`` and ``delta`` = rowsum(o·do), both (b, h, sq) fp32.
    Each kv head's dk / dv sums its GQA group."""
    s, valid, group = _setup(q, k, causal, q_offset, kv_len)
    scale = q.shape[-1] ** -0.5
    p = torch.where(valid, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    dof = do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    b, h, skv, d = dk.shape
    return (dq, dk.view(b, h // group, group, skv, d).sum(2),
            dv.view(b, h // group, group, skv, d).sum(2))
