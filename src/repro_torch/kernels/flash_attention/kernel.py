"""ctypes binding of the CUDA flash-attention forward
(``csrc/flash_attention_fwd.cu``; the source's header says which TPU
kernel it replaces, what bounds it and how).

The wrapper checks what the kernel cannot take and raises: bf16 CUDA
tensors on one device, head dim 64 or 128 with unit stride, 16-byte
aligned rows.  It allocates the output (and the optional logsumexp),
launches on PyTorch's current stream, raises on a launch error and
counts the launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.telemetry import get_registry

LAUNCHES = get_registry().counter("kernel.flash_attention.launches")
_FN: dict = {}


def _fn():
    if "fwd" not in _FN:
        fn = build.load("flash_attention").flash_attention_fwd
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P, I, I, I,
                       ctypes.c_float, P]
        fn.restype = I
        _FN["fwd"] = fn
    return _FN["fwd"]


def check_attn_tensor(name: str, t: torch.Tensor, device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
    if t.shape[-1] not in (64, 128) or t.stride(-1) != 1:
        raise ValueError(f"{name}: head dim must be 64 or 128 with unit "
                         f"stride, got shape {tuple(t.shape)} strides "
                         f"{t.stride()}")
    if any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be 16-byte aligned")


def flash_attention_fwd(q, k, v, *, causal=True, q_offset=None,
                        kv_len=None, save_lse=False):
    """q (b, h, sq, d); k/v (b, kvh, skv, d), any strides with a
    contiguous head dim.  Returns o (b, h, sq, d) — a view over
    (b, sq, h, d) memory, so the model's layout needs no transpose — and,
    with ``save_lse``, the per-row logsumexp (b, h, sq) fp32.

    ``q_offset`` is the absolute position of q[0] among the keys
    (default skv - sq); ``kv_len`` masks keys at positions >= kv_len."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_attn_tensor(name, t, q.device)
    if k.shape != (b, kvh, skv, d) or v.shape != k.shape or h % kvh:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    q_offset = skv - sq if q_offset is None else int(q_offset)
    kv_len = skv if kv_len is None else int(kv_len)
    o = torch.empty((b, sq, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if save_lse else None)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *o.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    None if lse is None else lse.data_ptr(), b, h, kvh, sq,
                    skv, d, ctypes.cast(strides, ctypes.c_void_p),
                    int(bool(causal)), q_offset, kv_len, d ** -0.5, stream)
    build.check(err, "flash_attention_fwd")
    LAUNCHES.inc()
    return (o, lse) if save_lse else o
