"""Device resolution: the port runs on the card unless told otherwise.

Every entry point takes ``device`` (default ``"cuda"``).  Without a
usable CUDA device it raises; it never moves to the CPU on its own.
Tests and CPU tooling pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_device(device=None) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"`` -> a CUDA device (raises if CUDA
    is unavailable); ``"cpu"`` -> the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (CLI: --device cpu) to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def torch_dtype(name) -> torch.dtype:
    """Dtype by its JAX-package name (``"bfloat16"``, ``"float8_e4m3"``)."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(DTYPES)}")
