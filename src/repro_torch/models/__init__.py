"""Models of the port (dense decoder-only family so far)."""
from repro_torch.models.model_api import BaseLM, DecoderLM, build_model

__all__ = ["BaseLM", "DecoderLM", "build_model"]
