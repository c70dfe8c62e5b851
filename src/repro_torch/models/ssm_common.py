"""Sub-quadratic sequence-mixing helpers of the Mamba-2 block (port of
``repro/models/ssm_common.py``): the depthwise causal conv and its
streaming forms, and the SSD scan in its chunked, recurrent and
quadratic forms.  Plain PyTorch; the chunked scan's kernel lives in
``kernels.ssd_scan``."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_conv1d(x, w, b=None, state=None):
    """Depthwise causal conv. x (b, l, c), w (c, width) -> (b, l, c).

    ``state`` (b, width-1, c): the previous chunk's trailing raw inputs,
    used in place of the zero left-pad so a chunked stream is bitwise
    identical to one monolithic pass (a zero state *is* the zero pad)."""
    width = w.shape[-1]
    if state is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    # y[t] = sum_k x[t - width + 1 + k] * w[:, k], summed in k order
    y = xp[:, 0:x.shape[1], :] * w[:, 0]
    for k in range(1, width):
        y = y + xp[:, k:k + x.shape[1], :] * w[:, k]
    if b is not None:
        y = y + b
    return y


def conv_chunk_state(state, x_raw, width: int):
    """Next conv state after a chunk: last width-1 raw inputs of
    [state; x_raw] (state=None means a fresh zero window)."""
    if state is None:
        b, _, c = x_raw.shape
        state = torch.zeros((b, width - 1, c), dtype=x_raw.dtype,
                            device=x_raw.device)
    full = torch.cat([state.to(x_raw.dtype), x_raw], dim=1)
    return full[:, -(width - 1):, :]


def conv_state_update(state, x_new, w, b=None):
    """Streaming depthwise conv. state (b, width-1, c); x_new (b, 1, c)."""
    window = torch.cat([state, x_new], dim=1)           # (b, width, c)
    y = torch.einsum("bwc,cw->bc", window, w)[:, None, :]
    if b is not None:
        y = y + b
    return y, window[:, 1:, :]


def segsum(a):
    """a (..., c) log-decays -> (..., c, c): S[i,j]=sum_{j<k<=i} a_k, -inf
    above the diagonal (masked before ``exp``, so autograd never meets
    exp of the positive upper triangle)."""
    c = a.shape[-1]
    s = torch.cumsum(a, dim=-1)
    diff = s[..., :, None] - s[..., None, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, -torch.inf)


def ssd_chunk_step(hprev, xc, ac, Bc, Cc, out_dtype):
    """One chunk of the chunked scan: xc (b,c,h,p), ac (b,c,h), Bc/Cc
    (b,c,n), carried state hprev (b,h,p,n) fp32 -> (state after the
    chunk, y (b,c,h,p) in ``out_dtype``)."""
    ac = ac.float()
    xf, Bf, Cf = xc.float(), Bc.float(), Cc.float()
    L = torch.exp(segsum(ac.transpose(1, 2)))             # (b,h,c,c)
    # intra-chunk (diag) term
    scores = torch.einsum("bln,bsn->bls", Cf, Bf)         # (b,c,c)
    y_diag = torch.einsum("bls,bhls,bshp->blhp", scores, L, xf)
    # inter-chunk: contribution of the carried state
    cum = torch.cumsum(ac, dim=1)                          # (b,c,h)
    y_off = torch.einsum("bln,bhpn,blh->blhp", Cf, hprev, torch.exp(cum))
    # new carried state
    decay_to_end = torch.exp(cum[:, -1:, :] - cum)         # (b,c,h)
    hnew = torch.einsum("bsh,bshp,bsn->bhpn", decay_to_end, xf, Bf)
    hnew = hnew + hprev * torch.exp(cum[:, -1, :])[:, :, None, None]
    return hnew, (y_diag + y_off).to(out_dtype)


def ssd_chunked(x, a, B, C, chunk: int, h0=None, return_hprev=False):
    """Chunked state-space-dual scan (Mamba-2, arXiv:2405.21060 §6).

    x (b,l,h,p): inputs (already scaled by dt); a (b,l,h): log decay per step
    (dt*A, <=0); B (b,l,n), C (b,l,n) shared across heads (ngroups=1).
    Returns y (b,l,h,p) in x.dtype, final state (b,h,p,n) fp32, and with
    ``return_hprev`` the state entering each chunk (b,nc,h,p,n) fp32.

    A loop over chunks (the recurrence), the full matrix form within a
    chunk (the part ``kernels.ssd_scan`` runs on the card)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the "
                         f"chunk {chunk}")
    hstate = (torch.zeros((b, h, p, n), dtype=torch.float32,
                          device=x.device) if h0 is None else h0)
    ys, hprev = [], []
    for lo in range(0, l, chunk):
        sl = slice(lo, lo + chunk)
        hprev.append(hstate)
        hstate, y = ssd_chunk_step(hstate, x[:, sl], a[:, sl], B[:, sl],
                                   C[:, sl], x.dtype)
        ys.append(y)
    if return_hprev:
        return torch.cat(ys, dim=1), hstate, torch.stack(hprev, dim=1)
    return torch.cat(ys, dim=1), hstate


def ssd_recurrent_step(hprev, x_t, a_t, B_t, C_t):
    """One decode step. hprev (b,h,p,n); x_t (b,h,p); a_t (b,h); B/C (b,n)."""
    decay = torch.exp(a_t.float())[:, :, None, None]
    hnew = hprev * decay + torch.einsum("bhp,bn->bhpn", x_t.float(),
                                        B_t.float())
    y = torch.einsum("bhpn,bn->bhp", hnew, C_t.float())
    return hnew, y.to(x_t.dtype)


def ssd_reference(x, a, B, C):
    """O(l^2) oracle for ssd_chunked (tests only)."""
    l = x.shape[1]
    s = torch.cumsum(a.float(), dim=1)                         # (b,l,h)
    diff = s[:, :, None, :] - s[:, None, :, :]                 # (b,l,s,h)
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    L = torch.exp(diff.masked_fill(~mask[None, :, :, None], -torch.inf))
    scores = torch.einsum("bln,bsn->bls", C.float(), B.float())
    y = torch.einsum("bls,blsh,bshp->blhp", scores, L, x.float())
    return y.to(x.dtype)
