"""Decoder layers for training and the chunk-oriented serving forward
(port of ``repro/models/transformer.py``); the serving layers take the
MoE family's FFN in place of the dense MLP, and Whisper's decoder layers
a cross-attention sublayer over the encoder's K/V (``cross_kv``).

Layers are stacked along a leading axis, as in the JAX parameter tree;
where JAX runs ``lax.scan`` over that axis, the port loops over the
stacked slices (``layer_slice``, ``scan_layers``).  Weights are used in
whatever dtype they were loaded in (cast once at load when serving at
full width); ``.to(x.dtype)`` is a no-op then and casts fp32 masters
otherwise.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models.common import (activate, apply_norm, is_gated,
                                       norm_defs)
from repro_torch.models.moe import moe_defs
from repro_torch.models.params import p, tree_map


# ------------------------------- MLP ---------------------------------------


def mlp_defs(cfg, d_ff=None, prefix=""):
    d_ff = d_ff or cfg.d_ff
    d = cfg.d_model
    defs = {}
    if is_gated(cfg.activation):
        defs[prefix + "w_gate"] = p((d, d_ff), ("embed", "mlp"))
        defs[prefix + "w_up"] = p((d, d_ff), ("embed", "mlp"))
    else:
        defs[prefix + "w_up"] = p((d, d_ff), ("embed", "mlp"))
    defs[prefix + "w_down"] = p((d_ff, d), ("mlp", "embed"))
    return defs


def apply_mlp(cfg, params, x, prefix=""):
    cd = x.dtype
    if is_gated(cfg.activation):
        g = x @ params[prefix + "w_gate"].to(cd)
        u = x @ params[prefix + "w_up"].to(cd)
        h = activate(cfg.activation, g, u)
    else:
        h = activate(cfg.activation, x @ params[prefix + "w_up"].to(cd))
    return h @ params[prefix + "w_down"].to(cd)


# ----------------------------- one layer -----------------------------------


def layer_defs(cfg, cross_attention=False):
    """One layer's parameters: ln1_, attn_, (with ``cross_attention``
    Whisper's lnx_ and xattn_), ln2_ and the FFN's, mlp_ for the dense
    family or moe_ for the MoE family."""
    defs = {}
    defs.update({f"ln1_{k}": v for k, v in norm_defs(cfg).items()})
    defs.update({f"attn_{k}": v for k, v in attn.attn_defs(cfg).items()})
    if cross_attention:
        defs.update({f"lnx_{k}": v for k, v in norm_defs(cfg).items()})
        defs.update({f"xattn_{k}": v
                     for k, v in attn.attn_defs(cfg).items()})
    defs.update({f"ln2_{k}": v for k, v in norm_defs(cfg).items()})
    if cfg.moe is None:
        defs.update(mlp_defs(cfg, prefix="mlp_"))
    else:
        defs.update({f"moe_{k}": v for k, v in moe_defs(cfg).items()})
    return defs


def _sub(params, prefix):
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


def layer_slice(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked layer tree (views, no copies)."""
    return {k: v[i] for k, v in stacked.items()}


def attn_sublayer(cfg, lp, x, *, causal=True, positions=None):
    """The pre-norm attention half of a layer over a whole sequence,
    residual included. x (b, s, d)."""
    h = apply_norm(cfg, _sub(lp, "ln1_"), x, name="norm")
    q, k, v = attn.project_qkv(cfg, _sub(lp, "attn_"), h, positions=positions)
    o = attn.attention_core(cfg, q, k, v, causal=causal)
    return x + attn.out_proj(cfg, _sub(lp, "attn_"), o)


def cross_attn_sublayer(cfg, lp, x, xk, xv):
    """x + cross-attention of ln_x(x) over the encoder's K/V xk / xv (b,
    se, kv, hd), residual included: non-causal, every query sees every
    encoder frame (the flash kernels' non-causal path on the card, sq !=
    skv, one-row queries at a decode tick)."""
    h = apply_norm(cfg, _sub(lp, "lnx_"), x, name="norm")
    q = attn._proj(h, lp["xattn_wq"])
    o = attn.attention_core(cfg, q, xk, xv, causal=False)
    return x + attn.out_proj(cfg, _sub(lp, "xattn_"), o)


def dense_layer(cfg, lp, x, *, causal=True, positions=None, cross_kv=None):
    """Pre-norm transformer layer over a whole sequence. x (b, s, d);
    ``cross_kv`` (xk, xv): Whisper's decoder layer."""
    x = attn_sublayer(cfg, lp, x, causal=causal, positions=positions)
    if cross_kv is not None:
        x = cross_attn_sublayer(cfg, lp, x, *cross_kv)
    return _ffn_sublayer(cfg, lp, x, None)


def _ffn_sublayer(cfg, lp, x, ffn):
    """x + FFN(ln2(x)); ``ffn(lp, h) -> y`` (default: the dense MLP)."""
    h = apply_norm(cfg, _sub(lp, "ln2_"), x, name="norm")
    if ffn is None:
        return x + apply_mlp(cfg, lp, h, prefix="mlp_")
    return x + ffn(lp, h)


def paged_chunk_layer(cfg, lp, x, k_pool, v_pool, block_tables, positions,
                      slots, *, k_scale=None, v_scale=None, ffn=None):
    """One layer of a chunk (T >= 1 tokens) against a block-paged pool:
    write the chunk's K/V at ``slots`` (in place), then attend positions
    ``<=`` each token's own.  T = 1 is a decode tick.  ``ffn(lp, h) -> y``
    replaces the dense MLP (the MoE family's experts)."""
    h = apply_norm(cfg, _sub(lp, "ln1_"), x, name="norm")
    q, k, v = attn.project_qkv(cfg, _sub(lp, "attn_"), h,
                               positions=positions)
    attn.paged_cache_update(k_pool, v_pool, k, v, slots, k_scale, v_scale)
    o = attn.paged_chunk_attn(cfg, q, k_pool, v_pool, block_tables,
                              positions, k_scale=k_scale, v_scale=v_scale)
    x = x + attn.out_proj(cfg, _sub(lp, "attn_"), o)
    return _ffn_sublayer(cfg, lp, x, ffn)


def chunk_layer(cfg, lp, x, ck, cv, positions, *, fresh=False, ffn=None,
                cross_kv=None):
    """One layer of the chunk-oriented forward against a dense cache
    ck/cv (b, S, kv, hd), updated in place.  ``fresh=True`` is the
    caller's promise that the cache is factory-fresh and valid positions
    are lockstep ``arange`` rows: the layer then runs the causal flash
    core over the chunk itself instead of the cache.  ``ffn`` as in
    ``paged_chunk_layer``; ``cross_kv`` as in ``dense_layer``."""
    h = apply_norm(cfg, _sub(lp, "ln1_"), x, name="norm")
    q, k, v = attn.project_qkv(cfg, _sub(lp, "attn_"), h,
                               positions=positions)
    attn.chunk_cache_update(ck, cv, k, v, positions)
    if fresh:
        o = attn.attention_core(cfg, q, k, v, causal=True)
    else:
        o = attn.chunk_attention(cfg, q, ck, cv, positions)
    x = x + attn.out_proj(cfg, _sub(lp, "attn_"), o)
    if cross_kv is not None:
        x = cross_attn_sublayer(cfg, lp, x, *cross_kv)
    return _ffn_sublayer(cfg, lp, x, ffn)


# -------------------------- stacked-layer helpers ---------------------------


def stack_defs(defs: dict, n: int) -> dict:
    return tree_map(lambda d: p((n, *d.shape), ("layers", *d.axes), d.init,
                                d.scale, d.dtype), defs)


def scan_layers(fn, x, aux, stacked, *, remat=True):
    """Run ``fn(x, aux, layer_params) -> (x, aux)`` over stacked layers,
    a Python loop where JAX runs ``lax.scan`` over an (x, aux) carry
    (aux: the MoE family's summed aux loss, a zero for the dense one).
    With ``remat`` (and gradients on) each layer runs under
    ``torch.utils.checkpoint`` — the JAX per-layer ``jax.checkpoint``:
    only each layer's inputs are kept, and the backward recomputes the
    layer.  The stacked leaves are split with ``unbind``, whose backward
    stacks the per-layer gradients in one copy (indexing layer by layer
    would add a zero-filled full-depth tensor per layer)."""
    layers = {k: v.unbind(0) for k, v in stacked.items()}
    depth = len(next(iter(layers.values())))
    for i in range(depth):
        lp = {k: v[i] for k, v in layers.items()}
        if remat and torch.is_grad_enabled():
            x, aux = checkpoint(fn, x, aux, lp, use_reentrant=False)
        else:
            x, aux = fn(x, aux, lp)
    return x, aux
