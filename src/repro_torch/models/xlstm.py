"""xLSTM blocks (arXiv:2405.04517; port of ``repro/models/xlstm.py``):
mLSTM (matrix memory, chunked-parallel) and sLSTM (scalar memory, a
sequential scan with a block-diagonal recurrence).

The recurrences are plain PyTorch, as they are plain ``jnp`` in the JAX
package (no TPU kernel to port): ``lax.scan`` becomes a Python loop over
chunks (mLSTM) or tokens (sLSTM).  The cells compute in fp32 whatever
the stream dtype.  The mLSTM chunked form is exactly the stabilized
recurrence (tested against ``mlstm_recurrent_ref``); its cross-chunk
state is carried as the SSD scan's is.  The blocks' internal RMS norms
stay inline, as in JAX; only the model's final norm goes through
``apply_norm`` (and so the rmsnorm kernel).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import p
from repro_torch.models.ssm_common import (causal_conv1d, conv_chunk_state,
                                           conv_state_update)

NEG_INF = -1e30


def _gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _rms(x):
    """x * rsqrt(mean(x^2) + 1e-6) over the last axis (x fp32)."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6)


# ======================== mLSTM cell (chunked) =============================


def mlstm_init_cell(b, h, dh, device):
    """The cell state (C (b,h,dh,dh), n (b,h,dh), m (b,h)) of a fresh
    sequence: zeros and m = NEG_INF."""
    return (torch.zeros((b, h, dh, dh), dtype=torch.float32, device=device),
            torch.zeros((b, h, dh), dtype=torch.float32, device=device),
            torch.full((b, h), NEG_INF, dtype=torch.float32, device=device))


def mlstm_chunk_step(state, qc, kc, vc, ic, fc, scale):
    """One chunk of ``mlstm_chunked``: qc/kc/vc (b,c,h,dh) fp32, ic/fc
    (b,c,h) fp32, carried (C, n, m) -> (state after the chunk, out
    (b,c,h,dh) fp32)."""
    C, n, m = state
    c = qc.shape[1]
    cumf = torch.cumsum(fc, dim=1)                          # (b,c,h)
    logD = cumf[:, :, None, :] - cumf[:, None, :, :] + ic[:, None, :, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                 device=qc.device))
    logD = torch.where(mask[None, :, :, None], logD,
                       torch.full_like(logD, NEG_INF))      # (b,i,j,h)
    b_i = cumf + m[:, None, :]                              # (b,c,h)
    m_i = torch.maximum(logD.amax(dim=2), b_i)              # (b,c,h)
    S = torch.einsum("bihd,bjhd->bijh", qc, kc) * scale
    W = S * torch.exp(logD - m_i[:, :, None, :])
    inter = torch.exp(b_i - m_i)                            # (b,c,h)
    qs = qc * scale
    num = (torch.einsum("bijh,bjhd->bihd", W, vc)
           + inter[..., None] * torch.einsum("bhde,bihd->bihe", C, qs))
    den = W.sum(dim=2) + inter * torch.einsum("bhd,bihd->bih", n, qs)
    out = num / torch.maximum(den.abs(), torch.exp(-m_i))[..., None]
    # the state carried to the next chunk
    m_last = m_i[:, -1, :]                                  # (b,h)
    w_j = torch.exp(cumf[:, -1:, :] - cumf + ic - m_last[:, None, :])
    decay = torch.exp(cumf[:, -1, :] + m - m_last)          # (b,h)
    C_new = (decay[:, :, None, None] * C
             + torch.einsum("bjh,bjhd,bjhe->bhde", w_j, kc, vc))
    n_new = decay[..., None] * n + torch.einsum("bjh,bjhd->bhd", w_j, kc)
    return (C_new, n_new, m_last), out


def mlstm_chunked(q, k, v, ig, lf, chunk, state=None):
    """q, k, v (b,l,h,dh); ig (b,l,h) input-gate preactivation; lf
    (b,l,h) log forget gate.  Returns (out (b,l,h,dh) in q's dtype,
    state = (C (b,h,dh,dh), n (b,h,dh), m (b,h)) fp32).  ``l`` must be a
    multiple of min(chunk, l)."""
    b, l, h, dh = q.shape
    scale = dh ** -0.5
    c = min(chunk, l)
    if l % c:
        raise ValueError(f"length {l} is not a multiple of the chunk {c}")
    if state is None:
        state = mlstm_init_cell(b, h, dh, q.device)
    f32 = [t.float() for t in (q, k, v, ig, lf)]
    outs = []
    for lo in range(0, l, c):
        state, out = mlstm_chunk_step(state, *(t[:, lo:lo + c] for t in f32),
                                      scale)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1), state


def mlstm_step(state, q, k, v, ig, lf):
    """One decode step. q, k, v (b,h,dh); ig, lf (b,h)."""
    C, n, m = state
    scale = q.shape[-1] ** -0.5
    ig, lf = ig.float(), lf.float()
    m_new = torch.maximum(lf + m, ig)
    fp = torch.exp(lf + m - m_new)
    ip = torch.exp(ig - m_new)
    kf, vf = k.float(), v.float()
    C = fp[..., None, None] * C + ip[..., None, None] * torch.einsum(
        "bhd,bhe->bhde", kf, vf)
    n = fp[..., None] * n + ip[..., None] * kf
    qf = q.float() * scale
    num = torch.einsum("bhde,bhd->bhe", C, qf)
    den = torch.einsum("bhd,bhd->bh", n, qf)
    out = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return (C, n, m_new), out.to(q.dtype)


def mlstm_recurrent_ref(q, k, v, ig, lf):
    """Token-by-token oracle for ``mlstm_chunked`` (tests only)."""
    b, l, h, dh = q.shape
    state = mlstm_init_cell(b, h, dh, q.device)
    ys = []
    for t in range(l):
        state, out = mlstm_step(state, q[:, t], k[:, t], v[:, t], ig[:, t],
                                lf[:, t])
        ys.append(out)
    return torch.stack(ys, dim=1)


# ====================== sLSTM cell (sequential) ============================


def slstm_init_cell(b, h, dh, device):
    """(c, n, m, h) of a fresh sequence: n = 1e-6, m = -10, the rest 0."""
    z0 = torch.zeros((b, h, dh), dtype=torch.float32, device=device)
    return (z0, z0 + 1e-6, torch.full((b, h, dh), -10.0, dtype=torch.float32,
                                      device=device), z0)


def slstm_scan(zx, ix, fx, ox, R, state=None):
    """zx / ix / fx / ox (b,l,h,dh) gate preactivations from the input; R
    (4,h,dh,dh) block-diagonal recurrent weights (z, i, f, o order).
    Returns (h_out (b,l,h,dh) in zx's dtype, state = (c, n, m, hprev)).

    A token is 16 small ops: the loop keeps its tensors head-major (h, b,
    ...) so that the four gates' input terms plus their recurrent
    products R h_{t-1} are one ``baddbmm``."""
    b, l, h, dh = zx.shape
    if state is None:
        state = slstm_init_cell(b, h, dh, zx.device)
    c, n, m, hp = (x.transpose(0, 1) for x in state)        # (h, b, dh)
    Rh = R.float().permute(1, 2, 0, 3).reshape(h, dh, 4 * dh)
    gx = torch.stack([a.float() for a in (zx, ix, fx, ox)], dim=3)
    gx = gx.permute(1, 2, 0, 3, 4).reshape(l, h, b, 4 * dh)
    ys = []
    for t in range(l):
        pre = torch.baddbmm(gx[t], hp, Rh).view(h, b, 4, dh)
        z = torch.tanh(pre[:, :, 0])
        i_pre = pre[:, :, 1]
        o = torch.sigmoid(pre[:, :, 3])
        lm = F.logsigmoid(pre[:, :, 2]) + m
        m = torch.maximum(lm, i_pre)
        ip = torch.exp(i_pre - m)
        fp = torch.exp(lm - m)
        c = torch.addcmul(fp * c, ip, z)
        n = torch.addcmul(ip, fp, n)
        hp = o * (c / torch.clamp(n, min=1e-6))
        ys.append(hp)
    out = torch.stack(ys).permute(2, 0, 1, 3).to(zx.dtype)  # (b,l,h,dh)
    return out, tuple(x.transpose(0, 1).contiguous() for x in (c, n, m, hp))


# =========================== blocks ========================================


def _heads(cfg):
    d_in = cfg.ssm.expand * cfg.d_model
    return d_in, cfg.n_heads, d_in // cfg.n_heads


def mlstm_block_defs(cfg):
    d = cfg.d_model
    d_in, h, dh = _heads(cfg)
    return {
        "ln_scale": p((d,), ("embed",), init="ones"),
        "w_x": p((d, d_in), ("embed", "ssm_inner")),
        "w_z": p((d, d_in), ("embed", "ssm_inner")),
        "conv_w": p((d_in, cfg.ssm.conv_width), ("ssm_inner", "conv"),
                    init="small"),
        "conv_b": p((d_in,), ("ssm_inner",), init="zeros"),
        "w_q": p((d_in, d_in), ("ssm_inner", "heads")),
        "w_k": p((d_in, d_in), ("ssm_inner", "heads")),
        "w_v": p((d_in, d_in), ("ssm_inner", "heads")),
        "w_i": p((d_in, h), ("ssm_inner", "gates"), init="small"),
        "w_f": p((d_in, h), ("ssm_inner", "gates"), init="small"),
        "b_i": p((h,), ("gates",), init="zeros"),
        "b_f": p((h,), ("gates",), init="ones"),
        "gn_scale": p((d_in,), ("ssm_inner",), init="ones"),
        "w_down": p((d_in, d), ("ssm_inner", "embed")),
    }


def _mlstm_qkvgates(cfg, params, x):
    cd = x.dtype
    ln = (_rms(x.float()) * params["ln_scale"]).to(cd)
    return ln @ params["w_x"].to(cd), ln @ params["w_z"].to(cd)


def _mlstm_inner(cfg, params, xu, conv_fn):
    d_in, h, dh = _heads(cfg)
    b, l = xu.shape[0], xu.shape[1]
    cd = xu.dtype
    xc = conv_fn(xu)
    q = (xc @ params["w_q"].to(cd)).reshape(b, l, h, dh)
    k = (xc @ params["w_k"].to(cd)).reshape(b, l, h, dh)
    v = (xu @ params["w_v"].to(cd)).reshape(b, l, h, dh)
    ig = xu @ params["w_i"].to(cd) + params["b_i"].to(cd)
    fg = xu @ params["w_f"].to(cd) + params["b_f"].to(cd)
    return q, k, v, ig, F.logsigmoid(fg.float())


def _mlstm_out(cfg, params, hcell, z, x):
    d_in, h, dh = _heads(cfg)
    b, l = z.shape[0], z.shape[1]
    cd = z.dtype
    y = _rms(hcell.reshape(b, l, h, dh).float())
    y = (y.reshape(b, l, d_in) * params["gn_scale"]).to(cd)
    y = y * F.silu(z)
    return x + y @ params["w_down"].to(cd)


def _conv(params, state=None):
    return lambda xc: F.silu(causal_conv1d(
        xc, params["conv_w"].to(xc.dtype), params["conv_b"].to(xc.dtype),
        state=state))


def apply_mlstm_block(cfg, params, x):
    xu, z = _mlstm_qkvgates(cfg, params, x)
    q, k, v, ig, lf = _mlstm_inner(cfg, params, xu, _conv(params))
    hcell, _ = mlstm_chunked(q, k, v, ig, lf, cfg.ssm.chunk_size)
    return _mlstm_out(cfg, params, hcell, z, x)


def mlstm_block_prefill(cfg, params, x, state=None):
    """Chunk-capable prefill: ``state`` continues a previous chunk (the
    cell recurrence resumes from (C, n, m) and the causal conv window is
    seeded with the previous chunk's raw tail).  A length that is not a
    chunk multiple scans its divisible head, then one short chunk."""
    xu, z = _mlstm_qkvgates(cfg, params, x)
    conv_in = None if state is None else state["conv"]
    conv_state = conv_chunk_state(conv_in, xu, cfg.ssm.conv_width)
    q, k, v, ig, lf = _mlstm_inner(cfg, params, xu, _conv(params, conv_in))
    cell = None if state is None else (state["C"], state["n"], state["m"])
    l = x.shape[1]
    c = min(cfg.ssm.chunk_size, l)
    head = (l // c) * c
    if head == l:
        hcell, (C, n, m) = mlstm_chunked(q, k, v, ig, lf,
                                         cfg.ssm.chunk_size, state=cell)
    else:
        h1, cell = mlstm_chunked(*(t[:, :head] for t in (q, k, v, ig, lf)),
                                 cfg.ssm.chunk_size, state=cell)
        h2, (C, n, m) = mlstm_chunked(
            *(t[:, head:] for t in (q, k, v, ig, lf)), cfg.ssm.chunk_size,
            state=cell)
        hcell = torch.cat([h1, h2], dim=1)
    out = _mlstm_out(cfg, params, hcell, z, x)
    return out, {"C": C, "n": n, "m": m, "conv": conv_state}


def mlstm_block_decode(cfg, params, x, state):
    xu, z = _mlstm_qkvgates(cfg, params, x)
    y_conv, conv_state = conv_state_update(
        state["conv"], xu, params["conv_w"].to(xu.dtype),
        params["conv_b"].to(xu.dtype))
    q, k, v, ig, lf = _mlstm_inner(cfg, params, xu,
                                   lambda _: F.silu(y_conv))
    (C, n, m), out = mlstm_step((state["C"], state["n"], state["m"]),
                                q[:, 0], k[:, 0], v[:, 0], ig[:, 0],
                                lf[:, 0])
    out = _mlstm_out(cfg, params, out[:, None], z, x)
    return out, {"C": C, "n": n, "m": m, "conv": conv_state}


def slstm_block_defs(cfg):
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    ff = int(round(d * 4 / 3 / 64) * 64)
    return {
        "ln_scale": p((d,), ("embed",), init="ones"),
        "w_gates": p((d, 4 * d), ("embed", "gates")),
        "b_gates": p((4 * d,), ("gates",), init="zeros"),
        "R": p((4, h, dh, dh), ("gates", "heads", "head_dim", "head_dim"),
               init="small"),
        "gn_scale": p((d,), ("embed",), init="ones"),
        "ff_gate": p((d, ff), ("embed", "mlp")),
        "ff_up": p((d, ff), ("embed", "mlp")),
        "ff_down": p((ff, d), ("mlp", "embed")),
    }


def _slstm_pre(cfg, params, x):
    h = cfg.n_heads
    dh = cfg.d_model // h
    b, l, _ = x.shape
    cd = x.dtype
    ln = (_rms(x.float()) * params["ln_scale"]).to(cd)
    g = ln @ params["w_gates"].to(cd) + params["b_gates"].to(cd)
    return tuple(a.reshape(b, l, h, dh) for a in g.chunk(4, dim=-1))


def _slstm_post(cfg, params, hcell, x):
    b, l = x.shape[0], x.shape[1]
    cd = x.dtype
    y = _rms(hcell.reshape(b, l, cfg.d_model).float())
    x = x + (y * params["gn_scale"]).to(cd)
    hgate = _gelu(x @ params["ff_gate"].to(cd))
    hup = x @ params["ff_up"].to(cd)
    return x + (hgate * hup) @ params["ff_down"].to(cd)


def apply_slstm_block(cfg, params, x):
    hcell, _ = slstm_scan(*_slstm_pre(cfg, params, x), params["R"])
    return _slstm_post(cfg, params, hcell, x)


def slstm_block_prefill(cfg, params, x, state=None):
    """Chunk-capable prefill (and, at T = 1, the decode step): the
    per-token scan resumes from ``state``, so any chunking of a prompt is
    bitwise one monolithic scan."""
    st = None if state is None else (state["c"], state["n"], state["m"],
                                     state["h"])
    hcell, (c, n, m, hp) = slstm_scan(*_slstm_pre(cfg, params, x),
                                      params["R"], state=st)
    return _slstm_post(cfg, params, hcell, x), {"c": c, "n": n, "m": m,
                                                "h": hp}


slstm_block_decode = slstm_block_prefill


def xlstm_init_states(cfg, batch: int, compute_dtype, device=None) -> list:
    """Per-block decode states, ordered by ``cfg.block_pattern``, equal
    to the ``state=None`` initialisers inside ``mlstm_chunked`` /
    ``slstm_scan`` (so a chunked prompt resumes exactly like a fresh
    monolithic one)."""
    d_in, h, dh = _heads(cfg)
    hs = cfg.n_heads
    dhs = cfg.d_model // hs
    out = []
    for kind in cfg.block_pattern:
        if kind == "m":
            C, n, m = mlstm_init_cell(batch, h, dh, device)
            out.append({"C": C, "n": n, "m": m,
                        "conv": torch.zeros((batch, cfg.ssm.conv_width - 1,
                                             d_in), dtype=compute_dtype,
                                            device=device)})
        else:
            c, n, m, hp = slstm_init_cell(batch, hs, dhs, device)
            out.append({"c": c, "n": n, "m": m, "h": hp})
    return out
