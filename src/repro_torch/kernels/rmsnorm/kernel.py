"""RMSNorm on Hopper: the forward as a Triton kernel, the backward (dx
and dw together) as one CUDA C++ kernel.

Replaces the TPU kernels of ``src/repro/kernels/rmsnorm/kernel.py``:

- ``rmsnorm_fwd`` (``_rmsnorm_kernel`` / ``_rmsnorm_res_kernel``): per
  row, y = x * rsqrt(mean(x^2) + eps) * w in fp32, cast to x's dtype;
  optionally the row's rstd (n,) fp32, the residual the backward needs.
  One Triton program a row, the row whole in registers (d = 3072 fits
  one 4096-wide block): it reads x once and writes y once, bound by
  device-memory bandwidth.  Triton is imported when the kernel is first
  built, inside the launching function, so machines without it (the CPU
  test runs) can import this module.
- ``rmsnorm_bwd_dx`` and ``rmsnorm_bwd_dw`` (``_rmsnorm_bwd_dx_kernel``,
  ``_rmsnorm_bwd_dw_kernel``): ``rmsnorm_bwd`` binds
  ``csrc/rmsnorm_bwd.cu`` (its header says how it works and what bounds
  it), which computes dx = r * g - x * r^3 * sum(g * x) / d with
  g = dy * w, and dw = sum over rows of dy * x * r in fp32, in one pass
  over x and dy and a fixed-order sum of its blocks' dw partials: dx and
  dw are bitwise the same from run to run.  ``bwd_plan`` (pure Python)
  is its grid: blocks, threads, ring stages and each block's rows.
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
_JIT: dict = {}
tl = None   # triton.language, bound by _build()


def _build():
    """Define (once) the Triton kernels; triton is imported here."""
    global tl
    if _JIT:
        return _JIT
    import triton
    import triton.language as tl   # noqa: F811  (binds the module global)

    @triton.jit
    def _rmsnorm_fwd(x_ptr, w_ptr, y_ptr, r_ptr, stride_x, stride_y, n_cols,
                     eps, BLOCK: tl.constexpr, SAVE_RSTD: tl.constexpr):
        row = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        mask = cols < n_cols
        x = tl.load(x_ptr + row * stride_x + cols, mask=mask,
                    other=0.0).to(tl.float32)
        ms = tl.sum(x * x, axis=0) / n_cols
        r = 1.0 / tl.sqrt(ms + eps)
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        y = x * r * w
        tl.store(y_ptr + row * stride_y + cols,
                 y.to(y_ptr.dtype.element_ty), mask=mask)
        if SAVE_RSTD:
            tl.store(r_ptr + row, r)

    _JIT.update(fwd=_rmsnorm_fwd, next_pow2=triton.next_power_of_2)
    return _JIT


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


def _warps(block):
    return 8 if block >= 2048 else 4


def rmsnorm_fwd(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
                save_rstd: bool = False):
    """x (n, d) CUDA, unit stride along d; w (d,) -> y (n, d) in x.dtype,
    and with ``save_rstd`` also rstd (n,) fp32."""
    _check_rows("x", x, x.device)
    n, d = x.shape
    _check_vec("w", w, x.device, d)
    k = _build()
    y = torch.empty((n, d), dtype=x.dtype, device=x.device)
    rstd = torch.empty((n,), dtype=torch.float32, device=x.device) \
        if save_rstd else y
    if n:
        block = k["next_pow2"](d)
        with torch.cuda.device(x.device):
            k["fwd"][(n,)](x, w, y, rstd, x.stride(0), y.stride(0), d, eps,
                           BLOCK=block, SAVE_RSTD=save_rstd,
                           num_warps=_warps(block))
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


def _fn():
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
        err = _fn()(x.data_ptr(), w.data_ptr(), dy.data_ptr(),
                    rstd.data_ptr(), dx.data_ptr(), part.data_ptr(),
                    dw.data_ptr(), n, d, x.stride(0), dy.stride(0),
                    _KINDS[x.dtype], _KINDS[w.dtype], plan.blocks,
                    plan.threads, plan.stages, plan.slices,
                    torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "rmsnorm_bwd")
    LAUNCHES_BWD.inc()
    return dx, dw
