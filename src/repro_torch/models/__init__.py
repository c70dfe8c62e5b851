"""Models of the port: the dense and MoE decoder-only families and the
Zamba2 hybrid."""
from repro_torch.models.model_api import (BaseLM, DecoderLM, ZambaLM,
                                          build_model)

__all__ = ["BaseLM", "DecoderLM", "ZambaLM", "build_model"]
