"""Plain PyTorch versions of the rmsnorm kernels (the CPU path and the
oracles the kernels are held against on the card).

The backward functions are written as the TPU kernels' formulas from
the saved per-row rstd, not as autograd of the forward."""
import torch


def rmsnorm_fwd_ref(x, w, eps=1e-6):
    """x (..., d), w (d,) -> (y in x.dtype, rstd (...) fp32)."""
    xf = x.float()
    rstd = torch.rsqrt(xf.square().mean(dim=-1) + eps)
    return (xf * rstd[..., None] * w.float()).to(x.dtype), rstd


def rmsnorm_ref(x, w, eps=1e-6):
    return rmsnorm_fwd_ref(x, w, eps)[0]


def rmsnorm_bwd_dx_ref(x, w, dy, rstd):
    """x, dy (n, d); w (d,); rstd (n,) -> dx (n, d) fp32: with
    g = dy * w, dx = r * g - x * r^3 * sum(g * x) / d."""
    xf, r = x.float(), rstd[:, None]
    g = dy.float() * w.float()
    dot = (g * xf).sum(dim=-1, keepdim=True)
    return r * g - xf * (r * r * r) * (dot / x.shape[-1])


def rmsnorm_bwd_dw_ref(x, dy, rstd):
    """x, dy (n, d); rstd (n,) -> dw (d,) fp32 = sum over rows of
    dy * x * r."""
    return (dy.float() * x.float() * rstd[:, None]).sum(dim=0)
