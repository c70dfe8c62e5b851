"""Plain PyTorch versions of the top-k gating kernels (the CPU path and
the oracles the kernels are held against on the card).

``topk_gating_ref`` is the JAX package's oracle (``jax.nn.softmax`` then
``jax.lax.top_k``), differentiable by autograd.  ``topk_gating_fwd_ref``
repeats the kernel's arithmetic: the row max, ``exp``, a divide by the
row sum, then k rounds of max / argmax (lowest index on ties) / mask.
``topk_gating_bwd_ref`` writes out the TPU backward kernel's formula
from the saved logits and experts, not autograd of the forward."""
import torch

NEG_INF = -1e30       # a taken entry's value in later rounds, as on the TPU


def _softmax(logits):
    x = logits.float()
    p = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True)


def _renorm(w, renorm):
    if not renorm:
        return w
    return w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)


def topk_gating_ref(logits, k: int, renorm=True):
    """logits (T, E) -> (weights (T, k) f32, experts (T, k) int32): an
    fp32 softmax, the k largest probabilities in descending order with
    the lower index first among equals (a stable sort: ``torch.topk``
    promises no order among ties), renormalised by max(sum, 1e-9)."""
    p = torch.softmax(logits.float(), dim=-1)
    w, i = torch.sort(p, dim=-1, descending=True, stable=True)
    return _renorm(w[..., :k], renorm), i[..., :k].to(torch.int32)


def topk_gating_fwd_ref(logits, k: int, renorm=True):
    """The kernel's forward arithmetic: (weights (T, k) f32, experts
    (T, k) int32)."""
    cur = _softmax(logits)
    ws, idxs = [], []
    for _ in range(k):
        wj, ij = cur.max(dim=-1)          # first maximal index on ties
        ws.append(wj)
        idxs.append(ij)
        cur = cur.scatter(-1, ij[:, None], NEG_INF)
    w = torch.stack(ws, dim=-1)
    return _renorm(w, renorm), torch.stack(idxs, dim=-1).to(torch.int32)


def topk_gating_bwd_ref(logits, experts, dw, k: int, renorm=True):
    """dL/dlogits (T, E) in logits' dtype for (weights, _) =
    topk_gating(logits) and dL/dweights ``dw`` (T, k): p recomputed,
    wr = p[experts], S = max(sum wr, 1e-9), wn = wr / S,
    dwr = (dw - sum(dw * wn)) / S (dwr = dw without renorm),
    dp = dwr scattered to the experts, c = sum(dwr * wr),
    dlogits = p * (dp - c)."""
    p = _softmax(logits)
    idx = experts.long()
    dw = dw.float()
    wr = torch.gather(p, -1, idx)
    if renorm:
        S = torch.clamp(wr.sum(dim=-1, keepdim=True), min=1e-9)
        wn = wr / S
        dwr = (dw - (dw * wn).sum(dim=-1, keepdim=True)) / S
    else:
        dwr = dw
    dp = torch.zeros_like(p).scatter_add_(-1, idx, dwr)
    c = (dwr * wr).sum(dim=-1, keepdim=True)
    return (p * (dp - c)).to(logits.dtype)
