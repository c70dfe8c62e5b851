"""Dispatch for paged chunk attention — the one attention op of the paged
serving path (prefill chunks, decode ticks) and of dense-cache chunks
viewed as one block per sequence.

impl: "auto" (kernel on CUDA, plain on CPU) | "ref" (the plain version
anywhere).  A CUDA tensor under "auto" launches the kernel or raises.
No backward.
"""
from __future__ import annotations

from repro_torch.kernels.paged_chunk_attention.kernel import \
    paged_chunk_attention_fwd
from repro_torch.kernels.paged_chunk_attention.ref import \
    paged_chunk_attention_ref


def paged_chunk_attention(q, k_pool, v_pool, block_tables, positions,
                          k_scale=None, v_scale=None, *, impl="auto"):
    """q (b, T, h, d); k/v_pool (n_blocks, block_size, kvh, d) in
    bfloat16, float8_e4m3fn or int8; block_tables (b, nbmax) int32
    (entries past a sequence's live blocks must name a valid block);
    positions (b, T) int32, row t attends key positions <=
    positions[:, t], negative = padding -> zero rows; k/v_scale
    (n_blocks, block_size) fp32 per-token scales or None -> (b, T, h, d)
    in q.dtype."""
    if impl == "ref":
        return paged_chunk_attention_ref(q, k_pool, v_pool, block_tables,
                                         positions, k_scale, v_scale)
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r}")
    if not q.is_cuda:
        return paged_chunk_attention_ref(q, k_pool, v_pool, block_tables,
                                         positions, k_scale, v_scale)
    return paged_chunk_attention_fwd(q, k_pool, v_pool, block_tables,
                                     positions, k_scale, v_scale)
