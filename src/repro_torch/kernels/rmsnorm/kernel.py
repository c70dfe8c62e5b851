"""RMSNorm forward as a Triton kernel for Hopper.

Replaces the TPU kernel ``src/repro/kernels/rmsnorm/kernel.py:
rmsnorm_fwd`` (``_rmsnorm_kernel``): per row, y = x * rsqrt(mean(x^2) +
eps) * w computed in fp32 and cast to x's dtype.

What bounds it on the H100: one read of x and one write of y, 2 * n * d
* 2 bytes in bf16, against ~3 FLOPs per element — device-memory
bandwidth.  One program normalises one row held whole in registers (d =
3072 fits one 4096-wide block), so x is read once and y written once;
no tensor-core work, and a CUDA version would move the same bytes.

Triton is imported when the kernel is first built, inside the launching
function: machines without it (the CPU test runs) can import this
module.
"""
from __future__ import annotations

import torch

from repro_torch.telemetry import get_registry

LAUNCHES = get_registry().counter("kernel.rmsnorm.launches")
_JIT: dict = {}
tl = None   # triton.language, bound by _build()


def _build():
    """Define (once) the Triton kernel; triton is imported here."""
    global tl
    if "fwd" in _JIT:
        return _JIT["fwd"]
    import triton
    import triton.language as tl   # noqa: F811  (binds the module global)

    @triton.jit
    def _rmsnorm_fwd(x_ptr, w_ptr, y_ptr, stride_x, stride_y, n_cols, eps,
                     BLOCK: tl.constexpr):
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

    _JIT["fwd"] = (_rmsnorm_fwd, triton.next_power_of_2)
    return _JIT["fwd"]


def rmsnorm_fwd(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6):
    """x (n, d) CUDA, unit stride along d; w (d,) -> y (n, d) in x.dtype."""
    if not (x.is_cuda and w.is_cuda) or x.device != w.device:
        raise ValueError("rmsnorm_fwd takes CUDA tensors on one device")
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm_fwd: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    if x.stride(1) != 1 or not w.is_contiguous():
        raise ValueError("rmsnorm_fwd needs unit stride along the row")
    kernel, next_pow2 = _build()
    n, d = x.shape
    y = torch.empty((n, d), dtype=x.dtype, device=x.device)
    if n == 0:
        return y
    block = next_pow2(d)
    with torch.cuda.device(x.device):
        kernel[(n,)](x, w, y, x.stride(0), y.stride(0), d, eps, BLOCK=block,
                     num_warps=8 if block >= 2048 else 4)
    LAUNCHES.inc()
    return y
