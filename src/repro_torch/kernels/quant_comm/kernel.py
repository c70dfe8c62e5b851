"""ctypes bindings of the CUDA int8 quantize / dequantize kernels
(``csrc/quant_comm.cu``; the source's header says which TPU kernels they
replace, what bounds them and how).

Each wrapper checks what its kernel cannot take and raises: 1-D
contiguous tensors on one CUDA device, n % 256 == 0, x fp32 or bf16, q
int8, scales fp32 (n / 256,).  A view that does not start on a 16-byte
boundary is copied first (the kernels load 16 bytes at a time).  It
allocates the outputs, launches on PyTorch's current stream, raises on a
launch error and counts the launch; n = 0 launches nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.telemetry import get_registry

LAUNCHES_QUANT = get_registry().counter("kernel.quantize.launches")
LAUNCHES_DEQUANT = get_registry().counter("kernel.dequantize.launches")
BLOCK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN: dict = {}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    # x q s, nblocks dtype, stream
    "quantize_blockwise": [_P, _P, _P, _L, _I, _P],
    # q s out, n out_dtype, stream
    "dequantize_blockwise": [_P, _P, _P, _L, _I, _P],
}


def _fn(name):
    if name not in _FN:
        fn = getattr(build.load("quant_comm"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
        _FN[name] = fn
    return _FN[name]


def _flat(t, name, dtypes):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (n,), got "
                         f"{tuple(t.shape)} strides {t.stride()}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
    return t if t.data_ptr() % 16 == 0 else t.clone()


def quantize_fwd(x):
    """x (n,) fp32 or bf16, n % 256 == 0 -> (q int8 (n,), scales fp32
    (n / 256,))."""
    x = _flat(x, "x", tuple(_DTYPES))
    n = x.shape[0]
    if n % BLOCK:
        raise ValueError(f"quantize kernel takes n % {BLOCK} == 0, got {n}")
    q = torch.empty(n, dtype=torch.int8, device=x.device)
    s = torch.empty(n // BLOCK, dtype=torch.float32, device=x.device)
    if n == 0:
        return q, s
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn("quantize_blockwise")(x.data_ptr(), q.data_ptr(),
                                        s.data_ptr(), n // BLOCK,
                                        _DTYPES[x.dtype], stream)
    build.check(err, "quantize_blockwise")
    LAUNCHES_QUANT.inc()
    return q, s


def dequantize_fwd(q, s, out_dtype=torch.float32):
    """q (n,) int8, scales (n / 256,) fp32 -> q · s (n,) in ``out_dtype``
    (fp32 or bf16)."""
    q = _flat(q, "q", (torch.int8,))
    s = _flat(s, "s", (torch.float32,))
    n = q.shape[0]
    if n % BLOCK or s.shape[0] != n // BLOCK or s.device != q.device:
        raise ValueError(f"dequantize kernel takes q (n,) with n % {BLOCK} "
                         f"== 0 and s (n / {BLOCK},) on q's device; got "
                         f"{n}, {tuple(s.shape)} on {s.device}")
    if out_dtype not in _DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    out = torch.empty(n, dtype=out_dtype, device=q.device)
    if n == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn("dequantize_blockwise")(q.data_ptr(), s.data_ptr(),
                                          out.data_ptr(), n,
                                          _DTYPES[out_dtype], stream)
    build.check(err, "dequantize_blockwise")
    LAUNCHES_DEQUANT.inc()
    return out
