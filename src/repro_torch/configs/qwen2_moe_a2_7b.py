"""Qwen1.5/2-MoE-A2.7B — 60 routed experts top-4 + 4 shared experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf] 24L d_model=2048 16H (kv=16) d_ff=1408
vocab=151936, MoE 60e top-4, 4 shared experts (shared hidden = 4*1408).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151_936,
    activation="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408,
                  n_shared_experts=4, d_shared=4 * 1408, router="softmax",
                  capacity_factor=1.25),
)
