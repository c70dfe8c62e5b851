"""Plain PyTorch version of the rmsnorm kernel (the CPU path and the
oracle the kernel is held against on the card)."""
import torch


def rmsnorm_ref(x, w, eps=1e-6):
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)
