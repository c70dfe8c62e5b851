"""The paper's own benchmark models (Fig. 8/9): GPT2-medium, LLaMa-13B,
DeepSeekMoE-16B, used by the HaiScale scaling benchmarks."""
from repro_torch.configs.base import ModelConfig, MoEConfig

GPT2_MEDIUM = ModelConfig(
    name="gpt2-medium",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=50_257,
    activation="gelu",
    norm="layernorm",
    rope_theta=10_000.0,    # positional simplification vs learned-abs
    tie_embeddings=True,
)

LLAMA_13B = ModelConfig(
    name="llama-13b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=13_824,
    vocab_size=32_000,
    activation="swiglu",
)

DEEPSEEKMOE_16B = ModelConfig(
    name="deepseekmoe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102_400,
    activation="swiglu",
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408,
                  n_shared_experts=2, d_shared=2 * 1408,
                  router="softmax", capacity_factor=1.25),
)
