"""CodeQwen1.5-7B — Qwen1.5 dense arch (MHA, qkv bias, SwiGLU).

[hf:Qwen/CodeQwen1.5-7B; hf] 32L d_model=4096 32H (GQA kv=32) d_ff=13440
vocab=92416.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13_440,
    vocab_size=92_416,
    activation="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
