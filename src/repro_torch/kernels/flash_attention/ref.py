"""Plain PyTorch version of the flash-attention forward.

Unlike the JAX package's ``impl="ref"`` path (which always end-aligns),
this honours ``q_offset`` and ``kv_len`` exactly as the kernel does,
and — like the kernel — returns zero rows for queries that see no key.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, q_offset=None, kv_len=None):
    """q (b, h, sq, d); k/v (b, kvh, skv, d) -> (b, h, sq, d), fp32
    softmax, output in q.dtype."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if q_offset is None:
        q_offset = skv - sq
    kv_len = skv if kv_len is None else kv_len
    kf = k.float().repeat_interleave(h // kvh, dim=1)
    vf = v.float().repeat_interleave(h // kvh, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * (d ** -0.5)
    kpos = torch.arange(skv, device=q.device)
    valid = (kpos < kv_len)[None, :].expand(sq, skv)
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        valid = valid & (kpos[None, :] <= qpos[:, None])
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1) * valid
    o = torch.einsum("bhqk,bhkd->bhqd", w, vf)
    return o.to(q.dtype)
