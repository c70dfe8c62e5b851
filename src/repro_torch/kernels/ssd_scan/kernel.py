"""ctypes bindings of the CUDA SSD chunk-scan kernels, forward and
backward (``csrc/ssd_scan.cu``; the source's header says which TPU
kernels they replace, what bounds them and how).

Each wrapper checks what its kernel cannot take and raises: x (b, l, h,
p) and B, C (b, l, n) contiguous, fp32 or bf16, one dtype; a (b, l, h)
contiguous fp32; all on one CUDA device; p, n <= 64; a chunk c <= 256
that divides l (``ops.ssd_scan`` pads l).  It allocates the outputs and
the kernels' fp32 scratch, launches on PyTorch's current stream, raises
on a launch error and counts one launch per call.

The bf16 backward, and the bf16 forward when it saves h_prev (training),
run the Hopper kernels on the grid of ``scan_plan``: the chunks' local
states, their fold across the chunks, then the output or the gradients,
each launched as a programmatic dependent of the one before.  The bf16
forward without h_prev (serving) and fp32 inputs run the first port's
CUDA-core kernels (the source's header says why serving keeps them).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.telemetry import get_registry

LAUNCHES = get_registry().counter("kernel.ssd_scan.launches")
LAUNCHES_BWD = get_registry().counter("kernel.ssd_scan_bwd.launches")
MAX_DIM, MAX_CHUNK = 64, 256
# the plan: at most MAX_GROUP heads a block of the fold kernels, as many as
# keep the grid at WAVES_NUM / WAVES_DEN blocks an SM or more
MAX_GROUP = 4
WAVES_NUM, WAVES_DEN = 15, 8
H100_SMS = 132
TILE = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN: dict = {}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # x a B C y hfin hprev states totals, b l h p n chunk dtype group,
    # stream
    "ssd_scan_fwd": [_P] * 9 + [_I] * 8 + [_P],
    # x a B C hprev dy dhfin dx da dB dC states totals dh, b l h p n chunk
    # dtype group, stream
    "ssd_scan_bwd": [_P] * 14 + [_I] * 8 + [_P],
}


class ScanPlan(NamedTuple):
    """The bf16 kernels' grid for (b, l, h, chunk): ``group`` heads a
    block of the fold kernels (the last block may take fewer), ``groups``
    = ceil(h / group) blocks along the head axis (and dB / dC partials),
    ``blocks`` = b * nc * groups of them, ``state_blocks`` = b * nc * h
    blocks of the local-state kernel (one head each), ``tiles`` 64-row
    tiles a chunk."""
    group: int
    groups: int
    blocks: int
    state_blocks: int
    tiles: int


@functools.lru_cache(maxsize=256)
def scan_plan(b, l, h, chunk, sms=H100_SMS):
    """The grid from shapes and the SM count alone (never from the data,
    so a launch can be captured in a CUDA graph): the largest group of
    heads in (MAX_GROUP, ..., 2) whose grid keeps at least WAVES_NUM /
    WAVES_DEN blocks an SM, else 1.  A block's heads share its B and C
    tiles and add their dB / dC shares before they leave the kernel.
    Cached: a training step asks for the same few shapes on every call."""
    if b < 1 or h < 1 or not 1 <= chunk <= MAX_CHUNK or l < chunk or \
            l % chunk:
        raise ValueError(f"ssd_scan plan: b={b}, l={l}, h={h}, "
                         f"chunk={chunk} not taken")
    nc = l // chunk
    group = 1
    for g in range(MAX_GROUP, 1, -1):
        if WAVES_DEN * b * nc * -(-h // g) >= WAVES_NUM * sms:
            group = g
            break
    groups = -(-h // group)
    return ScanPlan(group, groups, b * nc * groups, b * nc * h,
                    -(-chunk // TILE))


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


def _scratch(x, b, l, h, p, n, chunk):
    """(group, local states (b, nc, h, p, n), decay totals (b, nc, h),
    folded states (b, nc, h, p, n)): the Hopper kernels' plan group and
    fp32 scratch."""
    group = scan_plan(b, l, h, chunk, build.sm_count(x.device)).group
    nc = l // chunk

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x.device)
    return group, f32(b, nc, h, p, n), f32(b, nc, h), f32(b, nc, h, p, n)


def _ptr(t):
    return None if t is None else t.data_ptr()


def ssd_scan_fwd(x, a, B, C, *, chunk, save_hprev=False):
    """-> (y (b,l,h,p) in x.dtype, h_final (b,h,p,n) fp32[, h_prev
    (b,nc,h,p,n) fp32: the state entering each chunk])."""
    b, l, h, p, n = _check(x, a, B, C, chunk)
    dev = x.device
    y = torch.empty_like(x)
    hfin = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    group, states, totals, hprev = 1, None, None, None
    if save_hprev and x.dtype == torch.bfloat16:     # the Hopper kernels
        group, states, totals, hprev = _scratch(x, b, l, h, p, n, chunk)
    elif save_hprev:
        hprev = torch.empty((b, l // chunk, h, p, n), dtype=torch.float32,
                            device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn("ssd_scan_fwd")(
            x.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), hfin.data_ptr(),
            _ptr(hprev), _ptr(states), _ptr(totals),
            b, l, h, p, n, chunk, _DTYPES[x.dtype], group, stream)
    build.check(err, "ssd_scan_fwd")
    LAUNCHES.inc()
    return (y, hfin, hprev) if save_hprev else (y, hfin)


def ssd_scan_bwd(x, a, B, C, hprev, dy, dhfin, *, chunk):
    """(dx, da, dB, dC) in the primal dtypes from the saved h_prev
    (b,nc,h,p,n) fp32, dy (b,l,h,p) (cast to x's dtype, as autograd
    hands it) and dL/dh_final (b,h,p,n).  The kernels write dB and dC
    as fp32 partials, one per plan group of heads (per head for fp32);
    one ``torch.sum`` over them (a fixed order, no atomics) makes the
    gradients."""
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
    group, states, totals, dh = 1, None, None, None
    if x.dtype == torch.bfloat16:                     # the Hopper kernels
        group, states, totals, dh = _scratch(x, b, l, h, p, n, chunk)
    parts = -(-h // group)
    dBp = torch.empty((b, parts, l, n), dtype=torch.float32, device=dev)
    dCp = torch.empty((b, parts, l, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn("ssd_scan_bwd")(
            x.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
            hprev.data_ptr(), dy.data_ptr(), dhfin.data_ptr(),
            dx.data_ptr(), da.data_ptr(), dBp.data_ptr(), dCp.data_ptr(),
            _ptr(states), _ptr(totals), _ptr(dh),
            b, l, h, p, n, chunk, _DTYPES[x.dtype], group, stream)
    build.check(err, "ssd_scan_bwd")
    LAUNCHES_BWD.inc()
    return dx, da, dBp.sum(dim=1).to(B.dtype), dCp.sum(dim=1).to(C.dtype)
