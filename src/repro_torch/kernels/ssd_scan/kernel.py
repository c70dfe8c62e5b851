"""ctypes bindings of the CUDA SSD chunk-scan kernels, forward and
backward (``csrc/ssd_scan.cu``; the source's header says which TPU
kernels they replace, what bounds them and how).

Each wrapper checks what its kernel cannot take and raises: x (b, l, h,
p) and B, C (b, l, n) contiguous, fp32 or bf16, one dtype; a (b, l, h)
contiguous fp32; all on one CUDA device; p, n <= 64; a chunk c <= 256
that divides l (``ops.ssd_scan`` pads l).  It allocates the outputs,
launches on PyTorch's current stream, raises on a launch error and
counts the launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.telemetry import get_registry

LAUNCHES = get_registry().counter("kernel.ssd_scan.launches")
LAUNCHES_BWD = get_registry().counter("kernel.ssd_scan_bwd.launches")
MAX_DIM, MAX_CHUNK = 64, 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN: dict = {}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # x a B C y hfin hprev, b l h p n chunk dtype, stream
    "ssd_scan_fwd": [_P] * 7 + [_I] * 7 + [_P],
    # x a B C hprev dy dhfin dx da dB dC, b l h p n chunk dtype, stream
    "ssd_scan_bwd": [_P] * 11 + [_I] * 7 + [_P],
}


def _fn(name):
    if name not in _FN:
        fn = getattr(build.load("ssd_scan"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
        _FN[name] = fn
    return _FN[name]


def _check(x, a, B, C, chunk):
    dev = x.device
    if not x.is_cuda:
        raise ValueError("x must be a CUDA tensor")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or B.dim() != 3:
        raise ValueError(f"want x (b, l, h, p) and B (b, l, n), got "
                         f"{tuple(x.shape)} and {tuple(B.shape)}")
    b, l, h, p = x.shape
    n = B.shape[-1]
    want = {"a": ((b, l, h), torch.float32), "B": ((b, l, n), x.dtype),
            "C": ((b, l, n), x.dtype)}
    for name, t in (("x", x), ("a", a), ("B", B), ("C", C)):
        if name != "x" and (tuple(t.shape), t.dtype) != want[name]:
            raise ValueError(f"{name} must be {want[name][0]} "
                             f"{want[name][1]}, got {tuple(t.shape)} "
                             f"{t.dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
    if not (1 <= p <= MAX_DIM and 1 <= n <= MAX_DIM):
        raise ValueError(f"ssd_scan kernel takes p, n <= {MAX_DIM}; got "
                         f"p={p}, n={n}")
    if not 1 <= chunk <= MAX_CHUNK or l < chunk or l % chunk:
        raise ValueError(f"ssd_scan kernel takes a chunk <= {MAX_CHUNK} "
                         f"that divides l; got chunk={chunk}, l={l}")
    return b, l, h, p, n


def ssd_scan_fwd(x, a, B, C, *, chunk, save_hprev=False):
    """-> (y (b,l,h,p) in x.dtype, h_final (b,h,p,n) fp32[, h_prev
    (b,nc,h,p,n) fp32: the state entering each chunk])."""
    b, l, h, p, n = _check(x, a, B, C, chunk)
    dev = x.device
    y = torch.empty_like(x)
    hfin = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    hprev = (torch.empty((b, l // chunk, h, p, n), dtype=torch.float32,
                         device=dev) if save_hprev else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn("ssd_scan_fwd")(
            x.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), hfin.data_ptr(),
            hprev.data_ptr() if save_hprev else None,
            b, l, h, p, n, chunk, _DTYPES[x.dtype], stream)
    build.check(err, "ssd_scan_fwd")
    LAUNCHES.inc()
    return (y, hfin, hprev) if save_hprev else (y, hfin)


def ssd_scan_bwd(x, a, B, C, hprev, dy, dhfin, *, chunk):
    """(dx, da, dB, dC) in the primal dtypes from the saved h_prev
    (b,nc,h,p,n) fp32, dy (b,l,h,p) (cast to x's dtype, as autograd
    hands it) and dL/dh_final (b,h,p,n).  The kernel writes each head's
    share of dB and dC in fp32; one ``torch.sum`` over heads (a fixed
    order, no atomics) makes the gradients."""
    b, l, h, p, n = _check(x, a, B, C, chunk)
    dev = x.device
    dy = dy.to(x.dtype).contiguous()
    dhfin = dhfin.to(torch.float32).contiguous()
    for name, t, shape in (("hprev", hprev, (b, l // chunk, h, p, n)),
                           ("dy", dy, (b, l, h, p)),
                           ("dhfin", dhfin, (b, h, p, n))):
        if (tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous()
                or (name == "hprev" and t.dtype != torch.float32)):
            raise ValueError(f"{name} must be contiguous {shape} on {dev}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    dx = torch.empty_like(x)
    da = torch.empty_like(a)
    dBp = torch.empty((b, h, l, n), dtype=torch.float32, device=dev)
    dCp = torch.empty((b, h, l, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn("ssd_scan_bwd")(
            x.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
            hprev.data_ptr(), dy.data_ptr(), dhfin.data_ptr(),
            dx.data_ptr(), da.data_ptr(), dBp.data_ptr(), dCp.data_ptr(),
            b, l, h, p, n, chunk, _DTYPES[x.dtype], stream)
    build.check(err, "ssd_scan_bwd")
    LAUNCHES_BWD.inc()
    return dx, da, dBp.sum(dim=1).to(B.dtype), dCp.sum(dim=1).to(C.dtype)
