"""Models of the port: the dense, MoE and VLM decoder-only families,
the Zamba2 hybrid, Whisper and xLSTM."""
from repro_torch.models.model_api import (BaseLM, DecoderLM, WhisperLM,
                                          XLSTMLM, ZambaLM, build_model)

__all__ = ["BaseLM", "DecoderLM", "WhisperLM", "XLSTMLM", "ZambaLM",
           "build_model"]
