"""GQA attention: projections, softmax cores, dense and paged KV caches
(port of ``repro/models/attention.py``).

Cores dispatch under ``cfg.attn_impl`` ("auto" | "ref"):
on CUDA tensors "auto" runs the hand-written kernels —
``kernels.flash_attention`` for training and fresh prefill, ``kernels.
paged_chunk_attention`` for every other chunk (paged pools, and dense
caches viewed as one block per sequence) — and on CPU tensors their
plain versions.

Cache writes update the cache tensors **in place** (``index_put_``):
where the JAX code returns new buffers and donates the old ones
(``serving/engine.py``'s donated step state, ``paged_cache.py``'s
donated pools), the port mutates the one copy it has.  Writes at
negative positions / slots (chunk padding) are masked out explicitly:
a torch index of -1 would wrap around instead of being dropped.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import apply_rope, rope_freqs
from repro_torch.models.params import p

NEG_INF = -1e30

# Quantized KV pool dtypes.  e4m3 values are clipped to +-448 before the
# cast; int8 is per-token absmax with round + clip.
KV_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float8_e4m3": torch.float8_e4m3fn,
    "int8": torch.int8,
}
_KV_QMAX = {torch.float8_e4m3fn: 448.0, torch.int8: 127.0}


def bits(t):
    """A float8 tensor as its uint8 bits (a view), anything else as is:
    copies and gathers of fp8 data go through the bits."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def quantize_kv(x, dtype):
    """Quantize K or V entries (..., kv, hd) -> (q, scale (...,) fp32):
    one absmax scale per cached token over its kv x hd values."""
    if dtype not in _KV_QMAX:
        return x.to(dtype), torch.ones(x.shape[:-2], dtype=torch.float32,
                                       device=x.device)
    qmax = _KV_QMAX[dtype]
    xf = x.float()
    absmax = xf.abs().amax(dim=(-2, -1))
    scale = torch.clamp(absmax / qmax, min=1e-12)
    y = xf / scale[..., None, None]
    if dtype == torch.int8:
        y = torch.round(y)
    y = torch.clamp(y, -qmax, qmax)
    return y.to(dtype), scale


# ----------------------------- params -------------------------------------


def attn_defs(cfg):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": p((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": p((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": p((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": p((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = p((h, hd), ("heads", "head_dim"), init="zeros")
        defs["bk"] = p((kv, hd), ("kv_heads", "head_dim"), init="zeros")
        defs["bv"] = p((kv, hd), ("kv_heads", "head_dim"), init="zeros")
    return defs


def _proj(x, w):
    """(b, s, d) x (d, h, hd) -> (b, s, h, hd) as one matmul."""
    d, h, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * hd)).unflatten(-1, (h, hd))


def project_qkv(cfg, params, x, positions=None, rope: bool = True):
    """x: (b, s, d) -> q (b,s,h,hd), k/v (b,s,kv,hd); RoPE applied."""
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    if rope and cfg.rope_theta:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        cos, sin = rope_freqs(cfg.head_dim, cfg.rope_theta, positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def out_proj(cfg, params, attn_out):
    """attn_out (b, s, h, hd) -> (b, s, d)."""
    wo = params["wo"].to(attn_out.dtype)
    h, hd, d = wo.shape
    return attn_out.flatten(-2) @ wo.reshape(h * hd, d)


# ------------------------- softmax attention cores -------------------------


def direct_attention(q, k, v, *, causal: bool, q_offset=0, mask=None):
    """Full-materialization softmax attention. q (b,sq,h,hd), k/v
    (b,skv,h,hd).  ``q_offset``: absolute position of q[0] relative to
    k[0]."""
    sq, hd = q.shape[1], q.shape[3]
    skv = k.shape[1]
    logits = torch.einsum("bqhk,bshk->bhqs", q, k).float() * hd ** -0.5
    neg = torch.full_like(logits, NEG_INF)
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        kpos = torch.arange(skv, device=q.device)
        logits = torch.where((qpos[:, None] >= kpos[None, :])[None, None],
                             logits, neg)
    if mask is not None:
        logits = torch.where(mask, logits, neg)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshk->bqhk", w, v)


def _impl(cfg, impl):
    return getattr(cfg, "attn_impl", "auto") if impl is None else impl


def attention_core(cfg, q, k, v, *, causal=True, q_offset=0, impl=None):
    """The training / prefill softmax core over the chunk itself: q
    (b,s,h,hd), k/v (b,s,kv,hd) -> (b,s,h,hd) through
    ``kernels.flash_attention`` (GQA folded into the kernels; the plain
    versions on CPU tensors), differentiable.  The transposes are views:
    the kernels read q, k, v and write o in this (b, s, h, hd) memory
    through strides, and the backward's dq, dk, dv come back in it."""
    from repro_torch.kernels.flash_attention import flash_attention
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal,
                        impl=_impl(cfg, impl), q_offset=q_offset)
    return o.transpose(1, 2)


# ------------------------------- KV cache ----------------------------------


def chunk_cache_update(cache_k, cache_v, k_new, v_new, positions):
    """Write a chunk of K/V into a dense cache at per-slot positions, in
    place.  cache_k/v: (b, S, kv, hd); k_new/v_new: (b, T, kv, hd);
    positions (b, T): negative = padding, not written."""
    bi, ti = torch.nonzero(positions >= 0, as_tuple=True)
    pi = positions[bi, ti].long()
    cache_k.index_put_((bi, pi), k_new[bi, ti].to(cache_k.dtype))
    cache_v.index_put_((bi, pi), v_new[bi, ti].to(cache_v.dtype))
    return cache_k, cache_v


def chunk_attention(cfg, q, cache_k, cache_v, positions, *, impl=None):
    """Chunk-of-T-tokens attention against a dense cache that already
    holds this chunk's K/V (write-then-attend).  The dense cache is the
    paged op's input viewed as one block of size S per sequence
    (n_blocks = b, table = arange(b)) — zero-copy."""
    from repro_torch.kernels.paged_chunk_attention import \
        paged_chunk_attention
    b = q.shape[0]
    tables = torch.arange(b, dtype=torch.int32, device=q.device)[:, None]
    return paged_chunk_attention(q, cache_k, cache_v, tables, positions,
                                 impl=_impl(cfg, impl))


# ---------------------------- paged KV cache --------------------------------


def paged_slot_index(block_tables, positions, block_size):
    """Flat pool index (``block_id * bs + offset``) of each slot's token
    at ``positions`` (b,) or (b, T); negative positions map to -1."""
    pos = positions if positions.dim() == 2 else positions[:, None]
    pw = torch.clamp(pos, min=0).long()
    blk = torch.gather(block_tables.long(), 1, pw // block_size)
    slots = torch.where(pos >= 0, blk * block_size + pw % block_size,
                        torch.full_like(blk, -1))
    return slots if positions.dim() == 2 else slots[:, 0]


def paged_cache_update(k_pool, v_pool, k_new, v_new, slots,
                       k_scale=None, v_scale=None):
    """Write a chunk of new K/V into a block-paged pool, in place.

    k_pool/v_pool: (n_blocks, bs, kv, hd); k_new/v_new: (b, T, kv, hd);
    slots (b, T) flat pool indices, negative = padding, not written.
    With ``k_scale``/``v_scale`` ((n_blocks, bs) fp32) the entries are
    quantized to the pool dtype and their scales written beside them.
    Returns the (same) pools, scales included when given."""
    nb, bs, kvh, hd = k_pool.shape
    s2 = slots if slots.dim() == 2 else slots[:, None]
    keep = s2.reshape(-1) >= 0
    idx = s2.reshape(-1)[keep]
    kn = k_new.reshape(-1, kvh, hd)[keep]
    vn = v_new.reshape(-1, kvh, hd)[keep]
    kf = bits(k_pool).view(nb * bs, kvh, hd)
    vf = bits(v_pool).view(nb * bs, kvh, hd)
    if k_scale is not None:
        kq, ks = quantize_kv(kn, k_pool.dtype)
        vq, vs = quantize_kv(vn, v_pool.dtype)
        kf.index_copy_(0, idx, bits(kq))
        vf.index_copy_(0, idx, bits(vq))
        k_scale.view(-1).index_copy_(0, idx, ks)
        v_scale.view(-1).index_copy_(0, idx, vs)
        return k_pool, v_pool, k_scale, v_scale
    kf.index_copy_(0, idx, kn.to(kf.dtype))
    vf.index_copy_(0, idx, vn.to(vf.dtype))
    return k_pool, v_pool


def paged_chunk_attn(cfg, q, k_pool, v_pool, block_tables, positions,
                     *, impl=None, k_scale=None, v_scale=None):
    """Chunk-of-T-tokens attention against a block-paged pool — the
    attention op of the paged serving path (prefill chunks and decode
    ticks).  positions (b, T) are already written (write-then-attend);
    negative = padding -> zero rows."""
    from repro_torch.kernels.paged_chunk_attention import \
        paged_chunk_attention
    o = paged_chunk_attention(q, k_pool, v_pool, block_tables, positions,
                              k_scale, v_scale, impl=_impl(cfg, impl))
    return o.to(q.dtype)
