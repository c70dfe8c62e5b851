"""ctypes bindings of the CUDA flash-attention kernels: the forward
(``csrc/flash_attention_fwd.cu``) and the two backward kernels, dK/dV
and dQ (``csrc/flash_attention_bwd.cu``).  Each source's header says
which TPU kernel it replaces, what bounds it and how.

Each wrapper checks what its kernel cannot take and raises: bf16 CUDA
tensors on one device, head dim 64 or 128 with unit stride, 16-byte
aligned rows.  It allocates the outputs, launches on PyTorch's current
stream, raises on a launch error and counts the launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.telemetry import get_registry

LAUNCHES = get_registry().counter("kernel.flash_attention.launches")
LAUNCHES_BWD_DKV = get_registry().counter(
    "kernel.flash_attention_bwd_dkv.launches")
LAUNCHES_BWD_DQ = get_registry().counter(
    "kernel.flash_attention_bwd_dq.launches")
_FN: dict = {}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                            _I, _I, _I, ctypes.c_float, _P],
    # q k v dout lse delta dq dk dv, b h kvh sq skv d, strides, causal
    # q_offset kv_len, scale, stream
    "flash_attention_bwd_dkv": [_P] * 9 + [_I] * 6 + [_P] + [_I] * 3 +
                               [ctypes.c_float, _P],
}
_ARGTYPES["flash_attention_bwd_dq"] = _ARGTYPES["flash_attention_bwd_dkv"]
_LIB = {"flash_attention_fwd": "flash_attention",
        "flash_attention_bwd_dkv": "flash_attention_bwd",
        "flash_attention_bwd_dq": "flash_attention_bwd"}


def _fn(name="flash_attention_fwd"):
    if name not in _FN:
        fn = getattr(build.load(_LIB[name]), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
        _FN[name] = fn
    return _FN[name]


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


def _bwd_inputs(q, k, v, do, lse, delta):
    """Check the backward's inputs; ``do`` gets a contiguous, 16-byte
    aligned head dim if autograd handed it another layout."""
    b, h, sq, d = q.shape
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} != q {tuple(q.shape)}")
    if do.stride(-1) != 1 or any(s % 8 for s in do.stride()[:-1]) or \
            do.data_ptr() % 16:
        do = do.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        check_attn_tensor(name, t, q.device)
    kvh, skv = k.shape[1], k.shape[2]
    if k.shape != (b, kvh, skv, d) or v.shape != k.shape or h % kvh:
        raise ValueError(f"flash attention backward: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, sq) or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous fp32 (b, h, sq) "
                             f"on {q.device}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    return do


def _bwd_launch(name, q, k, v, do, lse, delta, dq, dk, dv, causal,
                q_offset, kv_len):
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    q_offset = skv - sq if q_offset is None else int(q_offset)
    kv_len = skv if kv_len is None else int(kv_len)
    outs = [t if t is not None else q for t in (dq, dk, dv)]
    strides = (ctypes.c_longlong * 21)(*(
        s for t in (q, k, v, do, *outs) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            *(None if t is None else t.data_ptr() for t in (dq, dk, dv)),
            b, h, kvh, sq, skv, d, ctypes.cast(strides, ctypes.c_void_p),
            int(bool(causal)), q_offset, kv_len, d ** -0.5, stream)
    build.check(err, name)


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal=True,
                            q_offset=None, kv_len=None):
    """dK, dV (b, kvh, skv, d) in k's dtype — views over (b, skv, kvh, d)
    memory, the model's layout — from the forward's ``lse`` and
    ``delta`` = rowsum(o * do), both (b, h, sq) fp32.  Each kv head's
    gradient sums its whole GQA group inside the kernel."""
    do = _bwd_inputs(q, k, v, do, lse, delta)
    b, kvh, skv, d = k.shape
    dk = torch.empty((b, skv, kvh, d), dtype=k.dtype,
                     device=k.device).transpose(1, 2)
    dv = torch.empty_like(dk)
    _bwd_launch("flash_attention_bwd_dkv", q, k, v, do, lse, delta, None,
                dk, dv, causal, q_offset, kv_len)
    LAUNCHES_BWD_DKV.inc()
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal=True,
                           q_offset=None, kv_len=None):
    """dQ (b, h, sq, d) in q's dtype, a view over (b, sq, h, d) memory."""
    do = _bwd_inputs(q, k, v, do, lse, delta)
    b, h, sq, d = q.shape
    dq = torch.empty((b, sq, h, d), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    _bwd_launch("flash_attention_bwd_dq", q, k, v, do, lse, delta, dq,
                None, None, causal, q_offset, kv_len)
    LAUNCHES_BWD_DQ.inc()
    return dq
