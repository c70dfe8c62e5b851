"""Phi-4-mini 3.8B — RoPE SwiGLU GQA dense transformer.

[arXiv:2412.08905; hf] 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200_064,
    activation="swiglu",
    tie_embeddings=True,
    rope_theta=10_000.0,
)
