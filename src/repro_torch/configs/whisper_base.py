"""Whisper-base — encoder-decoder transformer, conv audio frontend (STUB).

[arXiv:2212.04356; unverified] 6L d_model=512 8H (kv=8) d_ff=2048
vocab=51865.  6 encoder + 6 decoder layers; the conv frontend is a stub —
``input_specs()`` provides precomputed frame embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,            # decoder layers
    encoder_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51_865,
    activation="gelu",
    norm="layernorm",
    rope_theta=0.0,        # whisper uses learned/sinusoidal abs positions
    frontend="audio_stub",
    tie_embeddings=True,
)
