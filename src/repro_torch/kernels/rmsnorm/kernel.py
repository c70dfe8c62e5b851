"""RMSNorm forward and backward as Triton kernels for Hopper.

Replaces the TPU kernels of ``src/repro/kernels/rmsnorm/kernel.py``:

- ``rmsnorm_fwd`` (``_rmsnorm_kernel`` / ``_rmsnorm_res_kernel``): per
  row, y = x * rsqrt(mean(x^2) + eps) * w in fp32, cast to x's dtype;
  optionally the row's rstd (n,) fp32, the residual the backward needs.
- ``rmsnorm_bwd_dx`` (``_rmsnorm_bwd_dx_kernel``): with g = dy * w,
  dx = r * g - x * r^3 * sum(g * x) / d.
- ``rmsnorm_bwd_dw`` (``_rmsnorm_bwd_dw_kernel``): per row block the
  partial sums of dy * x * r, then one ``torch.sum`` over the blocks, as
  the JAX wrapper sums in jnp: two passes and no atomics, so dw is
  deterministic.

What bounds them on the H100: each reads its (n, d) inputs once and
writes its output once, against about 3-5 FLOPs per element and no
tensor-core work — device-memory bandwidth.  The forward and dx run one
program per row, the row held whole in registers (d = 3072 fits one
4096-wide block), so every byte moves once.  dw runs one program per
(64-row block, 256-column slice), 16 rows at a time, so a 4096-row step
has hundreds of programs in flight.

Triton is imported when a kernel is first built, inside the launching
function: machines without it (the CPU test runs) can import this
module.
"""
from __future__ import annotations

import torch

from repro_torch.telemetry import get_registry

LAUNCHES = get_registry().counter("kernel.rmsnorm.launches")
LAUNCHES_BWD_DX = get_registry().counter("kernel.rmsnorm_bwd_dx.launches")
LAUNCHES_BWD_DW = get_registry().counter("kernel.rmsnorm_bwd_dw.launches")
DW_ROWS = 64        # rows per dw partial (the partial count divisor)
DW_COLS = 256       # columns per dw program
DW_CHUNK = 16       # rows a dw program loads at once
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

    @triton.jit
    def _rmsnorm_bwd_dx(x_ptr, w_ptr, dy_ptr, r_ptr, dx_ptr, stride_x,
                        stride_dy, stride_dx, n_cols, BLOCK: tl.constexpr):
        row = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        mask = cols < n_cols
        x = tl.load(x_ptr + row * stride_x + cols, mask=mask,
                    other=0.0).to(tl.float32)
        dy = tl.load(dy_ptr + row * stride_dy + cols, mask=mask,
                     other=0.0).to(tl.float32)
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        r = tl.load(r_ptr + row)
        g = dy * w
        dot = tl.sum(g * x, axis=0)
        dx = r * g - x * (r * r * r) * (dot / n_cols)
        tl.store(dx_ptr + row * stride_dx + cols,
                 dx.to(dx_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def _rmsnorm_bwd_dw(x_ptr, dy_ptr, r_ptr, part_ptr, stride_x, stride_dy,
                        n_rows, n_cols, ROWS: tl.constexpr,
                        COLS: tl.constexpr, CHUNK: tl.constexpr):
        blk = tl.program_id(0)
        cols = tl.program_id(1) * COLS + tl.arange(0, COLS)
        cmask = cols < n_cols
        acc = tl.zeros((COLS,), dtype=tl.float32)
        for i in range(0, ROWS, CHUNK):
            rows = blk * ROWS + i + tl.arange(0, CHUNK)
            rmask = rows < n_rows
            m2 = rmask[:, None] & cmask[None, :]
            x = tl.load(x_ptr + rows[:, None] * stride_x + cols[None, :],
                        mask=m2, other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + rows[:, None] * stride_dy + cols[None, :],
                         mask=m2, other=0.0).to(tl.float32)
            r = tl.load(r_ptr + rows, mask=rmask, other=0.0)
            acc += tl.sum(dy * x * r[:, None], axis=0)
        tl.store(part_ptr + blk * n_cols + cols, acc, mask=cmask)

    _JIT.update(fwd=_rmsnorm_fwd, dx=_rmsnorm_bwd_dx, dw=_rmsnorm_bwd_dw,
                next_pow2=triton.next_power_of_2)
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


def rmsnorm_bwd_dx(x, w, dy, rstd):
    """dL/dx (n, d) in x.dtype for y = x * rstd * w; x, dy (n, d) with
    unit stride along d, w (d,), rstd (n,) fp32."""
    _check_rows("x", x, x.device)
    n, d = x.shape
    _check_rows("dy", dy, x.device, n, d)
    _check_vec("w", w, x.device, d)
    _check_vec("rstd", rstd, x.device, n, torch.float32)
    k = _build()
    dx = torch.empty((n, d), dtype=x.dtype, device=x.device)
    if n:
        block = k["next_pow2"](d)
        with torch.cuda.device(x.device):
            k["dx"][(n,)](x, w, dy, rstd, dx, x.stride(0), dy.stride(0),
                          dx.stride(0), d, BLOCK=block,
                          num_warps=_warps(block))
        LAUNCHES_BWD_DX.inc()
    return dx


def rmsnorm_bwd_dw(x, dy, rstd):
    """dL/dw (d,) fp32: the kernel writes one fp32 partial per block of
    ``DW_ROWS`` rows, and one ``torch.sum`` adds the partials."""
    _check_rows("x", x, x.device)
    n, d = x.shape
    _check_rows("dy", dy, x.device, n, d)
    _check_vec("rstd", rstd, x.device, n, torch.float32)
    k = _build()
    blocks = -(-n // DW_ROWS)
    part = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    if n:
        with torch.cuda.device(x.device):
            k["dw"][(blocks, -(-d // DW_COLS))](
                x, dy, rstd, part, x.stride(0), dy.stride(0), n, d,
                ROWS=DW_ROWS, COLS=DW_COLS, CHUNK=DW_CHUNK, num_warps=4)
        LAUNCHES_BWD_DW.inc()
    return part.sum(dim=0)
