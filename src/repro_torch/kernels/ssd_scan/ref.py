"""Plain PyTorch versions of the SSD chunk-scan kernels (the CPU path and
the oracles the kernels are held against on the card).

``ssd_ref`` is the model's own chunked scan and ``ssd_quadratic_ref``
the O(l^2) closed form, both differentiable by autograd.
``ssd_fwd_ref`` is the forward that also returns each chunk's incoming
state (the backward's residual), and ``ssd_bwd_ref`` writes out the TPU
backward kernel (``repro/kernels/ssd_scan/kernel.py:_ssd_bwd_kernel``)
chunk by chunk in reverse, from the saved states, not autograd of the
forward.  Every sequence length here is a multiple of ``chunk``."""
import torch

from repro_torch.models.ssm_common import segsum, ssd_chunked, ssd_reference


def ssd_ref(x, a, B, C, chunk=256):
    return ssd_chunked(x, a, B, C, min(chunk, x.shape[1]))


def ssd_quadratic_ref(x, a, B, C):
    return ssd_reference(x, a, B, C)


def ssd_fwd_ref(x, a, B, C, chunk):
    """x (b,l,h,p); a (b,l,h) fp32; B/C (b,l,n) -> (y (b,l,h,p) in
    x.dtype, h_final (b,h,p,n) fp32, h_prev (b,nc,h,p,n) fp32: the state
    entering each chunk)."""
    return ssd_chunked(x, a, B, C, chunk, return_hprev=True)


def ssd_bwd_ref(x, a, B, C, hprev, dy, dhfin, chunk):
    """Reverse chunked recurrence: (dx, da, dB, dC) in the primal dtypes
    from h_prev (b,nc,h,p,n), dy (b,l,h,p) and dL/dh_final (b,h,p,n).
    ``dh`` carries dL/d(state entering the next chunk), starting from
    ``dhfin``; dB and dC are summed over heads."""
    l = x.shape[1]
    dh = dhfin.float()
    dxs, das, dBs, dCs = [], [], [], []
    for ci in reversed(range(l // chunk)):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        xc, ac = x[:, sl].float(), a[:, sl].float()          # (b,c,h,p)
        Bc, Cc = B[:, sl].float(), C[:, sl].float()          # (b,c,n)
        dyc, hin, dhout = dy[:, sl].float(), hprev[:, ci].float(), dh

        cum = torch.cumsum(ac, dim=1)                         # (b,c,h)
        ecum = torch.exp(cum)
        ecum_last = ecum[:, -1]                               # (b,h)
        L = torch.exp(segsum(ac.transpose(1, 2))).permute(0, 2, 3, 1)
        scores = torch.einsum("bln,bsn->bls", Cc, Bc)        # (b,l,s)

        # intra-chunk (diag) term: y_diag = einsum(scores, L, x)
        G = torch.einsum("bshp,blhp->blsh", xc, dyc)          # (b,l,s,h)
        LG = L * G
        dscores = LG.sum(-1)
        SL = scores[..., None] * L
        dx = torch.einsum("blsh,blhp->bshp", SL, dyc)
        dC = torch.einsum("bls,bsn->bln", dscores, Bc)
        dB = torch.einsum("bls,bln->bsn", dscores, Cc)
        SLG = SL * G
        dcum = SLG.sum(2) - SLG.sum(1)                        # (b,c,h)

        # inter-chunk term: y_off = einsum(C, h_in, exp(cum))
        hC = torch.einsum("blhp,bhpn->blhn", dyc, hin)
        dC = dC + torch.einsum("blhn,blh->bln", hC, ecum)
        dhin = torch.einsum("blh,blhp,bln->bhpn", ecum, dyc, Cc)
        dcum = dcum + ecum * torch.einsum("blhn,bln->blh", hC, Cc)

        # state carry: h_out = einsum(decay_end, x, B) + h_in*exp(cum_c)
        de = torch.exp(cum[:, -1:, :] - cum)                  # (b,s,h)
        Bdh = torch.einsum("bsn,bhpn->bshp", Bc, dhout)
        dx = dx + de[..., None] * Bdh
        dB = dB + torch.einsum("bsh,bshp,bhpn->bsn", de, xc, dhout)
        dde = (xc * Bdh).sum(-1)                              # (b,s,h)
        dhin = dhin + dhout * ecum_last[:, :, None, None]
        dcum = dcum - de * dde
        dcum_last = ((de * dde).sum(1) + ecum_last
                     * torch.einsum("bhpn,bhpn->bh", hin, dhout))
        dcum[:, -1] = dcum[:, -1] + dcum_last

        # da[t] = sum_{u>=t} dcum[u], the kernel's flip-free form
        s_ = torch.cumsum(dcum, dim=1)
        da = s_[:, -1:] - s_ + dcum
        dxs.append(dx.to(x.dtype))
        das.append(da.to(a.dtype))
        dBs.append(dB.to(B.dtype))
        dCs.append(dC.to(C.dtype))
        dh = dhin
    return tuple(torch.cat(t[::-1], dim=1) for t in (dxs, das, dBs, dCs))
