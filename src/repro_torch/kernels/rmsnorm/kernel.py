"""RMSNorm on Hopper: the forward and the backward (dx and dw together),
each one CUDA C++ kernel.

Replaces the TPU kernels of ``src/repro/kernels/rmsnorm/kernel.py``:

- ``rmsnorm_fwd`` (``_rmsnorm_kernel`` / ``_rmsnorm_res_kernel``): per
  row, y = x * rsqrt(mean(x^2) + eps) * w in fp32, cast to x's dtype;
  optionally the row's rstd (n,) fp32, the residual the backward needs.
  ``rmsnorm_fwd`` binds ``csrc/rmsnorm_fwd.cu`` (its header says how it
  works and what bounds it): a block a row at a time, the row in
  registers, the sum of squares in a fixed order, persistent blocks
  that load the next row before they reduce the current one.
  ``fwd_plan`` (pure Python) is its grid and its load width.
- ``rmsnorm_bwd_dx`` and ``rmsnorm_bwd_dw`` (``_rmsnorm_bwd_dx_kernel``,
  ``_rmsnorm_bwd_dw_kernel``): ``rmsnorm_bwd`` binds
  ``csrc/rmsnorm_bwd.cu`` (its header says how it works and what bounds
  it), which computes dx = r * g - x * r^3 * sum(g * x) / d with
  g = dy * w, and dw = sum over rows of dy * x * r in fp32, in one pass
  over x and dy and a fixed-order sum of its blocks' dw partials: dx and
  dw are bitwise the same from run to run.  ``bwd_plan`` (pure Python)
  is its grid: blocks, threads, ring stages and each block's rows.

The forward's wrapper does per call only what the launch needs: cheap
checks that raise, ``torch.empty`` for the outputs, the cached plan, one
ctypes call on PyTorch's current stream (``build.launch``), the error
check and the launch counter.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.telemetry import get_registry

LAUNCHES = get_registry().counter("kernel.rmsnorm.launches")
LAUNCHES_BWD = get_registry().counter("kernel.rmsnorm_bwd.launches")
# the forward's plan, from d alone: a block of FWD_WIDE_WARPS warps a row
# where next_pow2(d) >= FWD_WIDE_BLOCK elements, else FWD_NARROW_WARPS
# (the warps of the port's first, Triton, kernel, whose arithmetic it
# keeps), each thread next_pow2(d) / (32 * warps) 16-byte slices of it, at
# most FWD_MAX_SLICES; shorter rows than a block's slices, one slice a
# thread; blocks an SM: fwd_blocks_per_sm (the kernel's register budget,
# csrc/rmsnorm_fwd.cu:blocks_per_sm)
FWD_WIDE_WARPS, FWD_NARROW_WARPS, FWD_WIDE_BLOCK = 8, 4, 2048
FWD_MAX_SLICES = 8
# the backward's plan: a thread owns up to MAX_SLICES 16-byte column
# slices of a row, a block up to MAX_THREADS threads.  BLOCKS_PER_SM
# blocks an SM where a thread owns one slice, a block has at most
# PAIR_THREADS threads and both rings fit the SM, else one.  A ring
# stage is one (x row, dy row) pair; an SM's rings hold about
# RING_BYTES_PER_SM (2 to MAX_STAGES stages a block)
MAX_THREADS, MAX_SLICES = 512, 4
BLOCKS_PER_SM, PAIR_THREADS = 2, 384
MAX_STAGES, RING_BYTES_PER_SM = 4, 48 * 1024
SM_SHARED_BYTES = 227 * 1024
H100_SMS = 132
_KINDS = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_FN: dict = {}


def _check_rows(name, t, device, n=None, d=None):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}")
    if t.dim() != 2 or t.stride(1) != 1:
        raise ValueError(f"{name} must be 2-D with unit stride along the "
                         f"row, got {tuple(t.shape)} {t.stride()}")
    if (n is not None and t.shape[0] != n) or \
            (d is not None and t.shape[1] != d):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want ({n}, {d})")


def _check_vec(name, t, device, size, dtype=None):
    if not t.is_cuda or t.device != device or t.shape != (size,) or \
            not t.is_contiguous() or (dtype is not None and t.dtype != dtype):
        raise ValueError(f"{name} must be a contiguous ({size},) "
                         f"{dtype or ''} CUDA tensor on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} {t.device}")


class FwdPlan(NamedTuple):
    """The forward kernel's grid for (n, d): ``blocks`` persistent blocks
    of ``warps`` warps, each thread ``slices`` 16-byte slices of a row
    loaded ``width`` bytes at a time, and block b's rows ``rows[b]`` =
    (start, stop), contiguous, in order."""
    blocks: int
    warps: int
    width: int
    slices: int
    rows: tuple


def fwd_blocks_per_sm(slices, width):
    """Blocks of the forward an SM holds: 4, 2 at 4 slices a thread or at
    2-byte loads, 1 at 8 slices."""
    return 1 if slices == 8 else 2 if slices == 4 or width == 2 else 4


@functools.lru_cache(maxsize=1024)
def fwd_plan(n, d, elem_bytes=2, sms=H100_SMS, width=16):
    """The grid of ``rmsnorm_fwd`` for n rows of d elements of
    ``elem_bytes`` each, loaded ``width`` bytes at a time (16, or the
    largest power of two that divides x's address, its row stride and
    its row in bytes), from these and the SM count alone (never from the
    data, so a launch can be captured in a CUDA graph; warps and slices
    from d alone, so a row's bits do not depend on the batch).  Blocks:
    ``fwd_blocks_per_sm`` an SM, never more than n (n = 0: none); block b
    takes n // blocks rows, the first n % blocks blocks one more.
    Cached: a step asks for the same few shapes on every call."""
    vec = 16 // elem_bytes
    block = 1 << max(d - 1, 0).bit_length()      # next_pow2(d)
    warps = FWD_WIDE_WARPS if block >= FWD_WIDE_BLOCK else FWD_NARROW_WARPS
    slices = block // (vec * 32 * warps)
    if slices == 0:                 # a short row: one slice a thread
        warps = 1 << max(-(-d // (vec * 32)) - 1, 0).bit_length()
        slices = 1
    if d < 1 or slices > FWD_MAX_SLICES:
        raise ValueError(f"rmsnorm forward: d = {d} not taken (at most "
                         f"{FWD_MAX_SLICES * 32 * FWD_WIDE_WARPS * vec} of "
                         f"{elem_bytes}-byte elements)")
    if width not in (2, 4, 8, 16) or width < elem_bytes:
        raise ValueError(f"rmsnorm forward: width {width} bytes not taken "
                         f"for {elem_bytes}-byte elements")
    blocks = min(n, fwd_blocks_per_sm(slices, width) * sms)
    q, rem = divmod(n, blocks) if blocks else (0, 0)
    starts = [b * q + min(b, rem) for b in range(blocks + 1)]
    return FwdPlan(blocks, warps, width, slices,
                   tuple(zip(starts[:-1], starts[1:])))


def _width(x):
    """The forward's load width for x (n, d): 16 bytes, or the largest
    power of two that divides x's address, its row stride and its row in
    bytes."""
    esz = x.element_size()
    bits = x.data_ptr() | x.stride(0) * esz | x.shape[1] * esz
    return min(16, bits & -bits)


def fwd_plan_for(x):
    """``fwd_plan`` for x (n, d) on its card."""
    n, d = x.shape
    return fwd_plan(n, d, x.element_size(), build.sm_count(x.device),
                    _width(x))


class _FwdConfig(ctypes.Structure):
    """csrc/rmsnorm_fwd.cu:FwdConfig, the launch's shape and grid."""
    _fields_ = [(f, ctypes.c_int) for f in (
        "n", "d", "x_kind", "w_kind", "width", "slices", "blocks",
        "warps")] + [("eps", ctypes.c_float)]


@functools.lru_cache(maxsize=1024)
def _fwd_config(n, d, x_kind, w_kind, width, eps, sms):
    """The address of the forward's launch descriptor for this shape,
    built once (a ctypes call pays for each argument it converts) and
    kept alive by the cache, with the descriptor itself."""
    plan = fwd_plan(n, d, 4 if x_kind == _KINDS[torch.float32] else 2, sms,
                    width)
    cfg = _FwdConfig(n, d, x_kind, w_kind, width, plan.slices, plan.blocks,
                     plan.warps, eps)
    return ctypes.addressof(cfg), cfg


def _fn_fwd():
    if "fwd" not in _FN:
        fn = build.load("rmsnorm_fwd").rmsnorm_fwd
        P = ctypes.c_void_p
        # x w y rstd, sx, config, stream
        fn.argtypes = [P, P, P, P, ctypes.c_longlong, P, P]
        fn.restype = ctypes.c_int
        _FN["fwd"] = fn
    return _FN["fwd"]


def rmsnorm_fwd(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
                save_rstd: bool = False):
    """x (n, d) CUDA, unit stride along d, bf16 / fp16 / fp32; w (d,)
    contiguous of any of those on the same card -> y (n, d) in x.dtype,
    and with ``save_rstd`` also rstd (n,) fp32.  n = 0 launches
    nothing."""
    if not x.is_cuda or x.dim() != 2 or x.stride(1) != 1:
        raise ValueError(f"x must be a 2-D CUDA tensor with unit stride "
                         f"along the row, got {tuple(x.shape)} {x.stride()} "
                         f"on {x.device}")
    n, d = x.shape
    kind, w_kind = _KINDS.get(x.dtype), _KINDS.get(w.dtype)
    dev = x.device
    if kind is None or w_kind is None or w.shape != (d,) or \
            not w.is_contiguous() or w.get_device() != dev.index:
        raise ValueError(f"rmsnorm forward takes x bf16, fp16 or fp32 and "
                         f"w a contiguous ({d},) tensor of one of those on "
                         f"{dev}; got x {x.dtype}, w {tuple(w.shape)} "
                         f"{w.dtype} on {w.device}")
    y = torch.empty((n, d), dtype=x.dtype, device=dev)
    rstd = torch.empty((n,), dtype=torch.float32, device=dev) \
        if save_rstd else None
    if n:
        config = _fwd_config(n, d, kind, w_kind, _width(x), eps,
                             build.sm_count(dev))[0]
        err = build.launch(_fn_fwd(), dev.index, x.data_ptr(), w.data_ptr(),
                           y.data_ptr(), rstd.data_ptr() if save_rstd
                           else None, x.stride(0), config)
        build.check(err, "rmsnorm_fwd")
        LAUNCHES.inc()
    return (y, rstd) if save_rstd else y


class BwdPlan(NamedTuple):
    """The backward kernel's grid for (n, d): ``blocks`` persistent
    blocks of ``threads`` threads, each thread ``slices`` 16-byte column
    slices of a row, a ring of ``stages`` (x row, dy row) stages, and
    block b's rows ``rows[b]`` = (start, stop), contiguous, in order."""
    blocks: int
    threads: int
    stages: int
    slices: int
    rows: tuple


@functools.lru_cache(maxsize=256)
def bwd_plan(n, d, elem_bytes=2, sms=H100_SMS):
    """The grid of ``rmsnorm_bwd`` for n rows of d elements of
    ``elem_bytes`` each, from shapes and the SM count alone (never from
    the data, so a launch can be captured in a CUDA graph).  Blocks:
    BLOCKS_PER_SM an SM where a thread owns one slice, a block has at
    most PAIR_THREADS threads and both rings fit an SM, else one; never
    more than n (n = 0: none).  Block b takes n // blocks rows, the
    first n % blocks blocks one more.  Cached: a training step asks for
    the same few shapes on every call."""
    vec = 16 // elem_bytes
    vecs = -(-d // vec)
    slices = next((s for s in (1, 2, MAX_SLICES)
                   if -(-vecs // s) <= MAX_THREADS), None)
    if d < 1 or slices is None:
        raise ValueError(f"rmsnorm backward: d = {d} not taken (at most "
                         f"{MAX_SLICES * MAX_THREADS * vec} of "
                         f"{elem_bytes}-byte elements)")
    threads = 32 * -(-vecs // (32 * slices))
    stage = 2 * d * elem_bytes
    head = 64 + (2 * MAX_THREADS // 32 + 2 * threads) * 4 + 128
    pair = BLOCKS_PER_SM * (head + 2 * stage) <= SM_SHARED_BYTES
    per_sm = (BLOCKS_PER_SM if slices == 1 and threads <= PAIR_THREADS
              and pair else 1)
    stages = max(2, min(MAX_STAGES, RING_BYTES_PER_SM // (per_sm * stage)))
    blocks = min(n, per_sm * sms)
    q, rem = divmod(n, blocks) if blocks else (0, 0)
    starts = [b * q + min(b, rem) for b in range(blocks + 1)]
    return BwdPlan(blocks, threads, stages, slices,
                   tuple(zip(starts[:-1], starts[1:])))


def _fn_bwd():
    if "bwd" not in _FN:
        fn = build.load("rmsnorm_bwd").rmsnorm_bwd
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # x w dy rstd dx part dw, n d sx sdy x_kind w_kind, blocks threads
        # stages slices, stream
        fn.argtypes = [P, P, P, P, P, P, P, I, I, L, L, I, I, I, I, I, I, P]
        fn.restype = I
        _FN["bwd"] = fn
    return _FN["bwd"]


def rmsnorm_bwd(x, w, dy, rstd):
    """(dL/dx (n, d) in x.dtype, dL/dw (d,) fp32) for y = x * rstd * w:
    x, dy (n, d) of one dtype (bf16, fp16 or fp32) with unit stride along
    d, w (d,) of any of those, rstd (n,) fp32.  One launch of the fused
    kernel and its dw combine; n = 0 launches nothing (dw = 0)."""
    _check_rows("x", x, x.device)
    n, d = x.shape
    _check_rows("dy", dy, x.device, n, d)
    _check_vec("w", w, x.device, d)
    _check_vec("rstd", rstd, x.device, n, torch.float32)
    if x.dtype not in _KINDS or dy.dtype != x.dtype or w.dtype not in _KINDS:
        raise ValueError(f"rmsnorm backward takes x and dy of one dtype "
                         f"and w, each bf16, fp16 or fp32; got x {x.dtype}, "
                         f"dy {dy.dtype}, w {w.dtype}")
    plan = bwd_plan(n, d, x.element_size(), build.sm_count(x.device))
    dx = torch.empty((n, d), dtype=x.dtype, device=x.device)
    dw = torch.empty((d,), dtype=torch.float32, device=x.device)
    if n == 0:
        return dx, dw.zero_()
    part = torch.empty((plan.blocks, d), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        err = _fn_bwd()(x.data_ptr(), w.data_ptr(), dy.data_ptr(),
                    rstd.data_ptr(), dx.data_ptr(), part.data_ptr(),
                    dw.data_ptr(), n, d, x.stride(0), dy.stride(0),
                    _KINDS[x.dtype], _KINDS[w.dtype], plan.blocks,
                    plan.threads, plan.stages, plan.slices,
                    torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "rmsnorm_bwd")
    LAUNCHES_BWD.inc()
    return dx, dw
