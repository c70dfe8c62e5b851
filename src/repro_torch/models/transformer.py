"""Dense decoder layers for training and the chunk-oriented serving
forward (port of ``repro/models/transformer.py``).

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


def layer_defs(cfg):
    defs = {}
    defs.update({f"ln1_{k}": v for k, v in norm_defs(cfg).items()})
    defs.update({f"attn_{k}": v for k, v in attn.attn_defs(cfg).items()})
    defs.update({f"ln2_{k}": v for k, v in norm_defs(cfg).items()})
    defs.update(mlp_defs(cfg, prefix="mlp_"))
    return defs


def _sub(params, prefix):
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


def layer_slice(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked layer tree (views, no copies)."""
    return {k: v[i] for k, v in stacked.items()}


def dense_layer(cfg, lp, x, *, causal=True, positions=None):
    """Pre-norm transformer layer over a whole sequence. x (b, s, d)."""
    h = apply_norm(cfg, _sub(lp, "ln1_"), x, name="norm")
    q, k, v = attn.project_qkv(cfg, _sub(lp, "attn_"), h, positions=positions)
    o = attn.attention_core(cfg, q, k, v, causal=causal)
    x = x + attn.out_proj(cfg, _sub(lp, "attn_"), o)
    h = apply_norm(cfg, _sub(lp, "ln2_"), x, name="norm")
    return x + apply_mlp(cfg, lp, h, prefix="mlp_")


def paged_chunk_layer(cfg, lp, x, k_pool, v_pool, block_tables, positions,
                      slots, *, k_scale=None, v_scale=None):
    """One layer of a chunk (T >= 1 tokens) against a block-paged pool:
    write the chunk's K/V at ``slots`` (in place), then attend positions
    ``<=`` each token's own.  T = 1 is a decode tick."""
    h = apply_norm(cfg, _sub(lp, "ln1_"), x, name="norm")
    q, k, v = attn.project_qkv(cfg, _sub(lp, "attn_"), h,
                               positions=positions)
    attn.paged_cache_update(k_pool, v_pool, k, v, slots, k_scale, v_scale)
    o = attn.paged_chunk_attn(cfg, q, k_pool, v_pool, block_tables,
                              positions, k_scale=k_scale, v_scale=v_scale)
    x = x + attn.out_proj(cfg, _sub(lp, "attn_"), o)
    h = apply_norm(cfg, _sub(lp, "ln2_"), x, name="norm")
    return x + apply_mlp(cfg, lp, h, prefix="mlp_")


def chunk_layer(cfg, lp, x, ck, cv, positions, *, fresh=False):
    """One layer of the chunk-oriented forward against a dense cache
    ck/cv (b, S, kv, hd), updated in place.  ``fresh=True`` is the
    caller's promise that the cache is factory-fresh and valid positions
    are lockstep ``arange`` rows: the layer then runs the causal flash
    core over the chunk itself instead of the cache."""
    h = apply_norm(cfg, _sub(lp, "ln1_"), x, name="norm")
    q, k, v = attn.project_qkv(cfg, _sub(lp, "attn_"), h,
                               positions=positions)
    attn.chunk_cache_update(ck, cv, k, v, positions)
    if fresh:
        o = attn.attention_core(cfg, q, k, v, causal=True)
    else:
        o = attn.chunk_attention(cfg, q, ck, cv, positions)
    x = x + attn.out_proj(cfg, _sub(lp, "attn_"), o)
    h = apply_norm(cfg, _sub(lp, "ln2_"), x, name="norm")
    return x + apply_mlp(cfg, lp, h, prefix="mlp_")


# -------------------------- stacked-layer helpers ---------------------------


def stack_defs(defs: dict, n: int) -> dict:
    return tree_map(lambda d: p((n, *d.shape), ("layers", *d.axes), d.init,
                                d.scale, d.dtype), defs)


def scan_layers(fn, x, stacked, *, remat=True):
    """Run ``fn(x, layer_params) -> x`` over stacked layers, a Python loop
    where JAX runs ``lax.scan``.  With ``remat`` (and gradients on) each
    layer runs under ``torch.utils.checkpoint`` — the JAX per-layer
    ``jax.checkpoint``: only each layer's input is kept, and the backward
    recomputes the layer.  The stacked leaves are split with ``unbind``,
    whose backward stacks the per-layer gradients in one copy (indexing
    layer by layer would add a zero-filled full-depth tensor per layer)."""
    layers = {k: v.unbind(0) for k, v in stacked.items()}
    depth = len(next(iter(layers.values())))
    for i in range(depth):
        lp = {k: v[i] for k, v in layers.items()}
        if remat and torch.is_grad_enabled():
            x = checkpoint(fn, x, lp, use_reentrant=False)
        else:
            x = fn(x, lp)
    return x
