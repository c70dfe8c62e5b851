"""Mamba-2 block (SSD formulation, arXiv:2405.21060) for zamba2-style
hybrids (port of ``repro/models/mamba2.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import p
from repro_torch.models.ssm_common import (causal_conv1d, conv_chunk_state,
                                           conv_state_update, ssd_chunked,
                                           ssd_recurrent_step)


def _ssd(cfg, x, a, B, C, chunk, h0=None):
    """The chunked SSD scan under ``cfg.ssm_impl``, split as the JAX
    package splits it: a carried initial state ``h0`` (a mid-prompt
    prefill chunk, a ragged tail) takes the plain ``ssd_chunked``, since
    the kernel has no h0 input; "auto" takes ``kernels.ssd_scan`` (the
    kernel on a CUDA tensor, its plain forward and backward on a CPU
    one) for l > 1, and "ref" the plain scan."""
    if h0 is not None:
        return ssd_chunked(x, a, B, C, chunk, h0=h0)
    impl = getattr(cfg, "ssm_impl", "auto")
    if impl == "auto" and x.shape[1] > 1:
        from repro_torch.kernels.ssd_scan import ssd_scan
        return ssd_scan(x, a, B, C, chunk=chunk)
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown ssm_impl {impl!r}")
    return ssd_chunked(x, a, B, C, chunk)


def _dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.state_size
    return d_in, nheads, conv_dim


def mamba2_defs(cfg):
    s = cfg.ssm
    d, (d_in, nheads, conv_dim) = cfg.d_model, _dims(cfg)
    proj_out = 2 * d_in + 2 * s.state_size + nheads   # z, x, B, C, dt
    return {
        "in_proj": p((d, proj_out), ("embed", "ssm_inner")),
        "conv_w": p((conv_dim, s.conv_width), ("ssm_inner", "conv"),
                    init="small"),
        "conv_b": p((conv_dim,), ("ssm_inner",), init="zeros"),
        "dt_bias": p((nheads,), ("gates",), init="zeros"),
        "A_log": p((nheads,), ("gates",), init="ones"),
        "D": p((nheads,), ("gates",), init="ones"),
        "norm_scale": p((d_in,), ("ssm_inner",), init="ones"),
        "out_proj": p((d_in, d), ("ssm_inner", "embed")),
    }


def _project(cfg, params, u):
    s = cfg.ssm
    d_in, _, _ = _dims(cfg)
    zxbcdt = u @ params["in_proj"].to(u.dtype)
    z, xBC, dt = torch.split(
        zxbcdt, [d_in, d_in + 2 * s.state_size,
                 zxbcdt.shape[-1] - 2 * d_in - 2 * s.state_size], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())                   # (h,)
    return z, xBC, dt, A


def _gated_out(cfg, params, y, z):
    """y, z (b, l, d_in) -> out (b, l, d); the rmsnorm over d_in goes
    through ``kernels.rmsnorm`` under ``cfg.norm_impl``."""
    from repro_torch.kernels.rmsnorm import rmsnorm
    g = rmsnorm(y * F.silu(z), params["norm_scale"],
                impl=getattr(cfg, "norm_impl", "auto"))
    return g @ params["out_proj"].to(z.dtype)


def _split_xbc(cfg, xBC):
    s = cfg.ssm
    d_in, _, _ = _dims(cfg)
    return torch.split(xBC, [d_in, s.state_size, s.state_size], dim=-1)


def _conv(params, xBC, state=None):
    return F.silu(causal_conv1d(xBC, params["conv_w"].to(xBC.dtype),
                                params["conv_b"].to(xBC.dtype), state=state))


def apply_mamba2(cfg, params, u):
    """Train/prefill path. u (b, l, d) -> (b, l, d)."""
    s = cfg.ssm
    d_in, nheads, _ = _dims(cfg)
    b, l, _ = u.shape
    z, xBC, dt, A = _project(cfg, params, u)
    x, B, C = _split_xbc(cfg, _conv(params, xBC))
    xh = x.reshape(b, l, nheads, s.head_dim)
    a = dt * A                                                # (b,l,h)
    chunk = min(s.chunk_size, l)
    y, _ = _ssd(cfg, xh * dt[..., None].to(xh.dtype), a, B, C, chunk)
    y = y + params["D"].to(y.dtype)[None, None, :, None] * xh
    return _gated_out(cfg, params, y.reshape(b, l, d_in), z)


def mamba2_prefill(cfg, params, u, state=None):
    """Like apply but also return the streaming state for decode.

    ``state`` ({ssm (b,h,p,n), conv (b,w-1,c)}) continues a previous
    chunk: the SSD scan starts from the carried state and the causal
    conv window is seeded with the previous chunk's raw tail, so a
    prompt processed in chunks reproduces the monolithic pass."""
    s = cfg.ssm
    d_in, nheads, _ = _dims(cfg)
    b, l, _ = u.shape
    z, xBC, dt, A = _project(cfg, params, u)
    conv_in = None if state is None else state["conv"]
    conv_state = conv_chunk_state(conv_in, xBC, s.conv_width)
    x, B, C = _split_xbc(cfg, _conv(params, xBC, state=conv_in))
    xh = x.reshape(b, l, nheads, s.head_dim)
    a = dt * A
    xd = xh * dt[..., None].to(xh.dtype)
    h0 = None if state is None else state["ssm"]
    chunk = min(s.chunk_size, l)
    head = (l // chunk) * chunk
    if head == l:
        y, hfin = _ssd(cfg, xd, a, B, C, chunk, h0=h0)
    else:
        # ragged tail (any prompt length must serve): scan the divisible
        # head, then one short chunk carrying the state
        y1, h1 = _ssd(cfg, xd[:, :head], a[:, :head], B[:, :head],
                      C[:, :head], chunk, h0=h0)
        y2, hfin = ssd_chunked(xd[:, head:], a[:, head:], B[:, head:],
                               C[:, head:], l - head, h0=h1)
        y = torch.cat([y1, y2], dim=1)
    y = y + params["D"].to(y.dtype)[None, None, :, None] * xh
    out = _gated_out(cfg, params, y.reshape(b, l, d_in), z)
    return out, {"ssm": hfin, "conv": conv_state.to(u.dtype)}


def mamba2_decode(cfg, params, u, state):
    """One-token decode. u (b, 1, d); state {ssm (b,h,p,n), conv (b,w-1,c)}."""
    s = cfg.ssm
    d_in, nheads, _ = _dims(cfg)
    b = u.shape[0]
    z, xBC, dt, A = _project(cfg, params, u)
    xBC_out, conv_state = conv_state_update(
        state["conv"], xBC, params["conv_w"].to(xBC.dtype),
        params["conv_b"].to(xBC.dtype))
    x, B, C = _split_xbc(cfg, F.silu(xBC_out))
    xh = x.reshape(b, nheads, s.head_dim)
    a_t = (dt * A)[:, 0]                                      # (b,h)
    x_t = xh * dt[:, 0, :, None].to(xh.dtype)
    hnew, y = ssd_recurrent_step(state["ssm"], x_t, a_t, B[:, 0], C[:, 0])
    y = y + params["D"].to(y.dtype)[None, :, None] * xh
    out = _gated_out(cfg, params, y.reshape(b, 1, d_in), z)
    return out, {"ssm": hnew, "conv": conv_state}
