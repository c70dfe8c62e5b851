"""Zamba2-style hybrid: Mamba2 backbone + one *shared* attention+MLP block
applied every ``attn_period`` layers (port of ``repro/models/zamba.py``;
tied weights across invocations — the paper's per-invocation LoRA is the
JAX package's documented simplification too).

Parameters keep the JAX tree: ``mamba`` (each leaf stacked (L, ...)),
``pre_norm`` {"scale": (L, d)} and ``shared`` (one dense layer).
Attention caches are updated in place, as in ``models.transformer``."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models.params import p
from repro_torch.models.transformer import (chunk_layer, dense_layer,
                                            layer_defs, paged_chunk_layer,
                                            stack_defs)


def segments(cfg) -> list[int]:
    """Mamba-layer counts between shared-attention invocations."""
    per, n = cfg.attn_period, cfg.n_layers
    segs = [per] * (n // per)
    if n % per:
        segs.append(n % per)
    return segs


def n_attn_invocations(cfg) -> int:
    return cfg.n_layers // cfg.attn_period


def zamba_defs(cfg):
    return {
        "mamba": stack_defs(mamba2.mamba2_defs(cfg), cfg.n_layers),
        "shared": layer_defs(cfg),
        "pre_norm": stack_defs(
            {"scale": p((cfg.d_model,), ("embed",), init="ones")},
            cfg.n_layers),
    }


def _pre_norm(cfg, x, scale):
    """The Mamba layer's rmsnorm (eps 1e-6) through ``kernels.rmsnorm``."""
    from repro_torch.kernels.rmsnorm import rmsnorm
    return rmsnorm(x, scale, impl=getattr(cfg, "norm_impl", "auto"))


def _mamba_layer(cfg, x, lp, scale):
    return x + mamba2.apply_mamba2(cfg, lp, _pre_norm(cfg, x, scale))


def _layers(params):
    """[(layer params, pre-norm scale)]: views of the stacked Mamba leaves
    and pre-norm scales, split with ``unbind`` (in training its backward
    stacks the per-layer gradients in one copy)."""
    stacked = {k: v.unbind(0) for k, v in params["mamba"].items()}
    scales = params["pre_norm"]["scale"].unbind(0)
    return [({k: v[i] for k, v in stacked.items()}, scales[i])
            for i in range(len(scales))]


def zamba_forward(cfg, params, x, *, remat=True):
    """x (b, l, d) -> (b, l, d). Shared attn block after every segment.
    With ``remat`` (and gradients on) each Mamba layer and each
    invocation of the shared block runs under ``torch.utils.checkpoint``
    (the JAX ``jax.checkpoint``s): the shared block's attention
    internals would otherwise dominate live memory."""
    ckpt = remat and torch.is_grad_enabled()

    def run(fn, *args):
        if ckpt:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    layers = _layers(params)
    start = 0
    for si, seg in enumerate(segments(cfg)):
        for lp, scale in layers[start:start + seg]:
            x = run(lambda h, lp_, sc: _mamba_layer(cfg, h, lp_, sc), x, lp,
                    scale)
        start += seg
        if si < n_attn_invocations(cfg):
            x = run(lambda h, sp: dense_layer(cfg, sp, h, causal=True), x,
                    params["shared"])
    return x


def zamba_chunk(cfg, params, x, positions, state, *, fresh=False):
    """One chunk (T >= 1 tokens) through the hybrid stack.

    ``state`` is the hybrid SeqState ({"mamba": per-layer streaming
    states, "k"/"v": (I, b, S, kv, hd) dense attention caches}); the
    mamba recurrences resume from their carried states while the shared
    attention block writes into (in place) and attends against the dense
    cache at per-slot ``positions``.  ``fresh=True``: factory state,
    take the whole-sequence paths.  Returns (x, mamba_states)."""
    T = x.shape[1]
    layers = _layers(params)
    mamba_states = []
    inv, start = 0, 0
    for si, seg in enumerate(segments(cfg)):
        for li in range(start, start + seg):
            lp, scale = layers[li]
            xn = _pre_norm(cfg, x, scale)
            st = None if fresh else state["mamba"][li]
            if T == 1 and not fresh:
                out, st = mamba2.mamba2_decode(cfg, lp, xn, st)
            else:
                out, st = mamba2.mamba2_prefill(cfg, lp, xn, state=st)
            x = x + out
            mamba_states.append(st)
        start += seg
        if si < n_attn_invocations(cfg):
            x = chunk_layer(cfg, params["shared"], x, state["k"][inv],
                            state["v"][inv], positions, fresh=fresh)
            inv += 1
    return x, mamba_states


def zamba_paged_step(cfg, params, x, mamba, kp, vp, block_tables, pos,
                     k_scale=None, v_scale=None):
    """One token per slot against paged attention pools + per-slot mamba
    state.  x (b,1,d); kp/vp (I, n_blocks, bs, kv, hd), written in place;
    pos (b,) is each slot's write position.  Quantized pools carry
    per-token ``k_scale``/``v_scale`` (I, n_blocks, bs) beside them.
    Returns (x, mamba').

    Negative positions mark padding **per slot**: that slot's KV write
    is dropped and its mamba states carry through *unchanged*, so a
    ragged chunk cannot absorb padding into the recurrence."""
    pos2 = pos[:, None]
    slots = attn.paged_slot_index(block_tables, pos2, kp.shape[2])
    keep = pos >= 0                                      # (b,) per-slot

    def _gate(new, old):
        return torch.where(keep.reshape((-1,) + (1,) * (new.dim() - 1)),
                           new, old)

    layers = _layers(params)
    new_mamba, inv, start = [], 0, 0
    for si, seg in enumerate(segments(cfg)):
        for li in range(start, start + seg):
            lp, scale = layers[li]
            xn = _pre_norm(cfg, x, scale)
            out, st = mamba2.mamba2_decode(cfg, lp, xn, mamba[li])
            x = x + out
            new_mamba.append({k: _gate(v, mamba[li][k])
                              for k, v in st.items()})
        start += seg
        if si < n_attn_invocations(cfg):
            x = paged_chunk_layer(
                cfg, params["shared"], x, kp[inv], vp[inv], block_tables,
                pos2, slots,
                k_scale=None if k_scale is None else k_scale[inv],
                v_scale=None if v_scale is None else v_scale[inv])
            inv += 1
    return x, new_mamba


def zamba_mamba_init(cfg, batch: int, compute_dtype, device=None) -> list:
    """Factory per-layer mamba streaming states (what the SSD scan and
    conv window start from on a fresh sequence)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.state_size
    return [{"ssm": torch.zeros((batch, nheads, s.head_dim, s.state_size),
                                dtype=torch.float32, device=device),
             "conv": torch.zeros((batch, s.conv_width - 1, conv_dim),
                                 dtype=compute_dtype, device=device)}
            for _ in range(cfg.n_layers)]
