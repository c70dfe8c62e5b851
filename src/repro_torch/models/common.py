"""Shared model building blocks: norms, activations, RoPE, the loss
(port of ``repro/models/common.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import p


# ----------------------------- norms ------------------------------------


def norm_defs(cfg, name="norm"):
    d = {f"{name}_scale": p((cfg.d_model,), ("embed",), init="ones")}
    if cfg.norm == "layernorm":
        d[f"{name}_bias"] = p((cfg.d_model,), ("embed",), init="zeros")
    return d


def apply_norm(cfg, params, x, name="norm"):
    """Stats in fp32.  rmsnorm goes through ``kernels.rmsnorm`` under
    ``cfg.norm_impl``: on a CUDA tensor every call launches the Triton
    kernel, one-token decode included.  (The JAX package keeps T = 1 on
    its inline path to avoid a ``pallas_call`` per token; here the
    inline PyTorch version is itself five or more launches, so the one
    fused kernel is the cheaper choice at every T.)  The kernel scales
    in fp32 and casts once; layernorm keeps the JAX inline discipline —
    fp32 stats, scaling in the stream dtype."""
    dtype = x.dtype
    if cfg.norm == "rmsnorm":
        from repro_torch.kernels.rmsnorm import rmsnorm
        return rmsnorm(x, params[f"{name}_scale"],
                       impl=getattr(cfg, "norm_impl", "auto"))
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    inv = torch.rsqrt(var + 1e-5).to(dtype)
    y = (x - mean.to(dtype)) * inv
    return y * params[f"{name}_scale"].to(dtype) \
        + params[f"{name}_bias"].to(dtype)


# --------------------------- activations ---------------------------------


def activate(name: str, gate, up=None):
    """Gated activations take (gate, up); ungated take a single arg.
    gelu is the tanh approximation, ``jax.nn.gelu``'s default."""
    if name == "swiglu":
        return F.silu(gate) * up
    if name == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    if name == "squared_relu":
        r = F.relu(gate)
        return r * r
    if name == "gelu":
        return F.gelu(gate, approximate="tanh")
    raise ValueError(name)


def is_gated(name: str) -> bool:
    return name in ("swiglu", "geglu")


# ------------------------------ RoPE --------------------------------------


def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor):
    """positions: (...,) int -> cos/sin of shape (..., head_dim//2) fp32."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                        device=positions.device) / half))
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (b, s, h, dh); cos/sin: (b, s, dh//2) or (s, dh//2).  Half-split
    rotation in the stream dtype (angles computed in fp32)."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# ------------------------------ loss ---------------------------------------


def cross_entropy(logits, labels, mask=None):
    """logits (..., V), cast to fp32; labels (...); mask (...) optional.
    Mean NLL: logsumexp minus the label's logit, averaged over the
    tokens (over the masked-in tokens with ``mask``)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
