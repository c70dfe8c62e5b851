"""Weights carried across from the JAX package.

``params_from_numpy`` takes the JAX package's parameter tree as host
arrays (nested dicts of numpy arrays, e.g. ``jax.device_get(
model.init(key))``) and returns the port's nested dict of tensors with
the same keys and shapes: the stacked leading layer axis, ``wq (d,h,hd)``,
``wo (h,hd,d)``.  ``params_to_numpy`` goes the other way.  Extended
numpy dtypes (``ml_dtypes.bfloat16``, ``float8_e4m3fn``) travel through
a same-width integer view, so the round trip is bitwise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device, torch_dtype

# extended dtype name (numpy str(dtype)) -> (torch dtype, int view dtype)
_VIEWED = {
    "bfloat16": (torch.bfloat16, np.int16, torch.int16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.int8, torch.int8),
}


def tensor_from_numpy(a, device="cpu", dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy()               # e.g. jax.device_get results; 0-d kept
    name = str(a.dtype)
    if name in _VIEWED:
        tdt, npint, tint = _VIEWED[name]
        t = torch.from_numpy(a.view(npint)).view(tdt)
    else:
        t = torch.from_numpy(a)
    t = t.to(device)
    return t if dtype is None else t.to(torch_dtype(dtype))


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    for name, (tdt, npint, tint) in _VIEWED.items():
        if t.dtype == tdt:
            import ml_dtypes  # numpy has no bfloat16 / e4m3 of its own
            return t.view(tint).numpy().view(getattr(ml_dtypes, name))
    return t.numpy()


def params_from_numpy(tree, device=None, dtype=None) -> dict:
    """Nested dict of host arrays -> nested dict of tensors on ``device``
    (default: the card), optionally cast to ``dtype``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev, dtype) for k, v in tree.items()}
    return tensor_from_numpy(tree, dev, dtype)


def params_to_numpy(tree) -> dict:
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tensor_to_numpy(tree)
