"""Plain PyTorch version of the paged chunk-attention kernel: gather each
sequence's blocks in table order, dequantize, and run a dense fp32
softmax where row t attends key positions <= positions[:, t].  Rows at
position < 0 are exact zeros, as from the kernel."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _gather(pool, tables):
    """pool[tables]; float8 pools are gathered as their uint8 bits."""
    if pool.dtype == torch.float8_e4m3fn:
        return pool.view(torch.uint8)[tables].view(pool.dtype)
    return pool[tables]


def paged_chunk_attention_ref(q, k_pool, v_pool, block_tables, positions,
                              k_scale=None, v_scale=None):
    """q (b, T, h, d); k/v_pool (n_blocks, bs, kvh, d); block_tables
    (b, nbmax); positions (b, T); k/v_scale (n_blocks, bs) or None ->
    (b, T, h, d) in q.dtype."""
    b, T, h, d = q.shape
    kvh = k_pool.shape[2]
    tables = block_tables.long()
    k = _gather(k_pool, tables).reshape(b, -1, kvh, d).float()
    v = _gather(v_pool, tables).reshape(b, -1, kvh, d).float()
    if k_scale is not None:
        k = k * k_scale[tables].reshape(b, -1)[:, :, None, None]
        v = v * v_scale[tables].reshape(b, -1)[:, :, None, None]
    group = h // kvh
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k) * (d ** -0.5)
    kpos = torch.arange(k.shape[1], device=q.device)
    pos = positions.long()
    mask = kpos[None, None, :] <= pos[:, :, None]             # (b, T, S)
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhts,bshd->bthd", w, v)
    o = torch.where((pos >= 0)[:, :, None, None], o, torch.zeros_like(o))
    return o.to(q.dtype)
