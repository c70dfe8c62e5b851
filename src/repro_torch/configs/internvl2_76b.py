"""InternVL2-76B — VLM: InternViT frontend (STUB) + InternLM2-76B backbone.

[arXiv:2404.16821; unverified] 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256.  Per assignment the vision frontend is a stub:
``input_specs()`` provides precomputed patch embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28_672,
    vocab_size=128_256,
    activation="swiglu",
    rope_theta=1_000_000.0,
    frontend="patch_stub",
    n_frontend_tokens=256,
)
