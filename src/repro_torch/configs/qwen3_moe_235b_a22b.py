"""Qwen3-MoE 235B-A22B — 128 experts, top-8, GQA kv=4.

[hf:Qwen/Qwen3-30B-A3B; hf] 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128e top-8 (no shared expert).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,                 # == d_expert (kept for reference)
    vocab_size=151_936,
    activation="swiglu",
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536,
                  n_shared_experts=0, d_shared=0, router="softmax",
                  capacity_factor=1.25),
)
