from repro_torch.kernels.paged_chunk_attention.kernel import LAUNCHES
from repro_torch.kernels.paged_chunk_attention.ops import \
    paged_chunk_attention
from repro_torch.kernels.paged_chunk_attention.ref import \
    paged_chunk_attention_ref

__all__ = ["LAUNCHES", "paged_chunk_attention", "paged_chunk_attention_ref"]
