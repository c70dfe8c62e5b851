"""Zamba2-1.2B — hybrid: Mamba2 backbone + shared attention block.

[arXiv:2411.15242; hf] 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64.  The shared attention+MLP block is applied every
``attn_period`` Mamba2 layers with tied weights (per-invocation LoRA from
the paper is a noted simplification in DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32_000,
    activation="swiglu",
    ssm=SSMConfig(state_size=64, expand=2, conv_width=4, head_dim=64,
                  chunk_size=256),
    attn_period=6,
    tie_embeddings=True,
)
