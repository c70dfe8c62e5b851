"""xLSTM-125M — alternating sLSTM + mLSTM blocks (no separate FFN).

[arXiv:2405.04517; unverified] 12L d_model=768 4H (kv=4) d_ff=0
vocab=50304.  Block pattern follows the paper's mixed stacks: mLSTM-heavy
with periodic sLSTM blocks.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    activation="gelu",
    block_pattern="mmsmmsmmsmms",   # 8 mLSTM + 4 sLSTM
    ssm=SSMConfig(state_size=0, expand=2, conv_width=4, head_dim=384,
                  chunk_size=256),
    tie_embeddings=True,
)
