"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``) on one device.

Dispatch is the GShard/Switch grouped capacity-einsum formulation:
tokens are split into G groups of g; each group builds an (g, E, C)
dispatch tensor from a cumulative-position rank, and everything is
batched over G.  The JAX package's sharding constraints (``_shard_ge``,
``shard_act``) have no counterpart on one device.  The dispatch, expert
and combine einsums are plain products and stay ``torch.einsum``; the
softmax router's top-k selection goes through ``kernels.topk_gating``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import activate, is_gated
from repro_torch.models.params import p

# Dispatch-einsum cost per token scales with the group size (g * k * cf
# * d); 512 is the JAX package's default.
DEFAULT_GROUP = 512


def moe_defs(cfg):
    m, d = cfg.moe, cfg.d_model
    gated = is_gated(cfg.activation)
    defs = {"router": p((d, m.n_experts), ("embed", "expert"), init="small")}
    shp = (m.n_experts, d, m.d_expert)
    axes = ("expert", "embed", "moe_mlp")
    if gated:
        defs["e_gate"] = p(shp, axes)
    defs["e_up"] = p(shp, axes)
    defs["e_down"] = p((m.n_experts, m.d_expert, d),
                       ("expert", "moe_mlp", "embed"))
    if m.d_shared:
        if gated:
            defs["s_gate"] = p((d, m.d_shared), ("embed", "mlp"))
        defs["s_up"] = p((d, m.d_shared), ("embed", "mlp"))
        defs["s_down"] = p((m.d_shared, d), ("mlp", "embed"))
        defs["s_gate_proj"] = p((d, 1), ("embed", "mlp"), init="small")
    return defs


def _topk_renorm(scores, k):
    """The k largest scores (the lower index first among equals, as
    ``jax.lax.top_k``), renormalised by max(sum, 1e-9)."""
    w, e = torch.sort(scores, dim=-1, descending=True, stable=True)
    w, e = w[..., :k], e[..., :k]
    return w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9), e


def _route(cfg, logits, need_scores):
    """(weights (G, g, k) fp32, experts (G, g, k) int64, scores or None)
    for fp32 router logits (G, g, E)."""
    m = cfg.moe
    impl = getattr(cfg, "gate_impl", "auto")
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown gate_impl {impl!r}")
    if m.router == "sigmoid":
        scores = torch.sigmoid(logits)
        return (*_topk_renorm(scores, m.top_k), scores)
    if impl == "auto" and logits.is_cuda:
        # the kernel at every chunk width, decode included; ``scores``
        # stays dense for the aux loss only, so the router's gradient is
        # the kernel backward's dlogits plus autograd through ``scores``
        from repro_torch.kernels.topk_gating import topk_gating
        G, g, E = logits.shape
        w, e = topk_gating(logits.reshape(G * g, E), k=m.top_k, renorm=True)
        scores = torch.softmax(logits, dim=-1) if need_scores else None
        return (w.reshape(G, g, m.top_k),
                e.reshape(G, g, m.top_k).long(), scores)
    scores = torch.softmax(logits, dim=-1)
    return (*_topk_renorm(scores, m.top_k), scores)


def apply_moe(cfg, params, x, *, group_size=DEFAULT_GROUP, dropless=False,
              _aux=True):
    """x (b, s, d) -> (y (b, s, d), aux_loss).

    ``dropless=True`` removes the capacity constraint (cap = g, every
    (token, choice) fits): each token's output then depends only on its
    own routing, never on the other tokens of its group — the invariance
    chunked and padded serving prefill needs.  Training keeps the
    capacity-limited GShard form.  b * s must be a multiple of the group
    min(group_size, b * s), as the JAX reshape requires.

    ``_aux=False`` (the serving call sites only; they drop the aux loss,
    as XLA drops it from the JAX serving forward) skips the dense scores
    and the aux loss and returns None in its place; y is unchanged."""
    m = cfg.moe
    b, s, d = x.shape
    T = b * s
    g = min(group_size, T)
    if T % g:
        raise ValueError(f"apply_moe: {T} tokens are not a multiple of the "
                         f"group size {g}")
    G = T // g
    E, k = m.n_experts, m.top_k
    if dropless:
        # a token holds at most one slot per expert queue (its top-k
        # experts are distinct), so g capacity slots fit every entry
        cap = g
    else:
        cap = min(max(int(g * k / E * m.capacity_factor), k), g)
    xf = x.reshape(G, g, d)

    # ---- router (fp32) ----
    logits = xf.float() @ params["router"].float()
    weights, experts, scores = _route(cfg, logits, _aux)

    onehot = F.one_hot(experts, E).float()                   # (G,g,k,E)
    aux = None
    if _aux:
        # GShard load-balance aux loss
        probs_mean = scores.mean(dim=1)                      # (G,E)
        frac = onehot.mean(dim=(1, 2))                       # (G,E)
        aux = E * (probs_mean * frac).sum(dim=-1).mean() * \
            m.router_aux_weight

    # ---- capacity rank: position of each (token, choice) in its expert
    # queue, k-major so that first choices win capacity ----
    flat = onehot.transpose(1, 2).reshape(G, k * g, E)
    pos = torch.cumsum(flat, dim=1) - flat                   # (G,kg,E)
    pos = pos.reshape(G, k, g, E).transpose(1, 2)
    within = (pos * onehot).sum(dim=-1)                      # (G,g,k)
    keep = (within < cap).to(weights.dtype)
    wkeep = weights * keep
    # one-hot over the capacity slots; a dropped entry (within >= cap)
    # gets an all-zero row, as jax.nn.one_hot gives out of range
    cap_oh = (within.long()[..., None] ==
              torch.arange(cap, device=x.device)).float()    # (G,g,k,C)

    # sum over k as one batched product: at most one term is non-zero
    combine = torch.einsum("gske,gskc->gsec", onehot * wkeep[..., None],
                           cap_oh)                           # (G,g,E,C)
    dispatch = (combine > 0).to(x.dtype)

    # ---- dispatch -> expert FFN -> combine ----
    cd = x.dtype
    xe = torch.einsum("gsd,gsec->gecd", xf, dispatch)        # (G,E,C,d)
    if is_gated(cfg.activation):
        gg = torch.einsum("gecd,edf->gecf", xe, params["e_gate"].to(cd))
        uu = torch.einsum("gecd,edf->gecf", xe, params["e_up"].to(cd))
        h = activate(cfg.activation, gg, uu)
    else:
        h = activate(cfg.activation,
                     torch.einsum("gecd,edf->gecf", xe,
                                  params["e_up"].to(cd)))
    ye = torch.einsum("gecf,efd->gecd", h, params["e_down"].to(cd))
    y = torch.einsum("gecd,gsec->gsd", ye, combine.to(cd)).reshape(b, s, d)

    # ---- shared experts (Qwen2-MoE / DeepSeekMoE style) ----
    if m.d_shared:
        if is_gated(cfg.activation):
            h = activate(cfg.activation, x @ params["s_gate"].to(cd),
                         x @ params["s_up"].to(cd))
        else:
            h = activate(cfg.activation, x @ params["s_up"].to(cd))
        sh = h @ params["s_down"].to(cd)
        gate = torch.sigmoid(x @ params["s_gate_proj"].to(cd))
        y = y + gate * sh
    return y, aux
