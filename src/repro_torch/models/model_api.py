"""Chunk-oriented model API (port of ``repro/models/model_api.py``),
dense decoder-only family.

  init_seq_state(params, max_len, ...) -> SeqState
  forward(params, state, tokens, positions) -> (SeqState, logits)

``tokens`` is (b, T) for any T >= 1 (prompt, prefill chunk or decode
tick); ``positions`` (b, T) are absolute per-slot positions, negative =
padding (not written, skipped by the last-token logit gather).  A state
holding ``block_tables`` is a paged pool (``_forward_paged``); otherwise
it is a dense cache {k, v} of shape (L, b, S, kv, hd).  Cache tensors
are updated in place and returned in the new state.

Parameter trees have the JAX package's keys and shapes, so
``bridge.params_from_numpy`` loads JAX-initialised weights directly.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models.common import apply_norm, norm_defs
from repro_torch.models.params import init_tree, p
from repro_torch.models.transformer import (_sub, chunk_layer, layer_defs,
                                            layer_slice, paged_chunk_layer,
                                            stack_defs)


def _embed_defs(cfg):
    defs = {"embed": p((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                       init="embed", scale=0.02)}
    if not cfg.tie_embeddings:
        defs["unembed"] = p((cfg.d_model, cfg.vocab_size),
                            ("embed", "vocab"))
    defs.update({f"final_{k}": v for k, v in norm_defs(cfg).items()})
    return defs


def arange_positions(batch: int, length: int, offset: int = 0,
                     device=None):
    """Lockstep (b, T) positions ``offset + [0..T)`` for every slot."""
    return torch.arange(offset, offset + length, dtype=torch.int32,
                        device=device).expand(batch, length)


def last_valid_index(positions):
    """Index of each slot's last non-padding token within the chunk."""
    return torch.clamp((positions >= 0).sum(dim=1) - 1, min=0)


class BaseLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.compute_dtype = torch_dtype(cfg.compute_dtype)

    def init(self, seed: int = 0, *, device=None, dtype=None):
        """Parameters drawn on ``device`` (default: the card; raises
        without CUDA unless ``device="cpu"``), in ``dtype`` (default:
        each ParamDef's, fp32)."""
        return init_tree(self.param_defs(), seed, device=device,
                         dtype=dtype)

    def _embed(self, params, tokens):
        return params["embed"][tokens.long()].to(self.compute_dtype)

    def _logits(self, params, x):
        x = apply_norm(self.cfg, _sub(params, "final_"), x, name="norm")
        if self.cfg.tie_embeddings:
            w = params["embed"].t()
        else:
            w = params["unembed"]
        return x @ w.to(x.dtype)

    def _gather_logits(self, params, x, positions):
        """Project only each slot's last valid chunk row to (b, V)."""
        idx = last_valid_index(positions)
        xl = x[torch.arange(x.shape[0], device=x.device), idx]
        return self._logits(params, xl[:, None])[:, 0]

    def _chunk_logits(self, params, x, positions, all_logits):
        if all_logits:
            return self._logits(params, x)
        return self._gather_logits(params, x, positions)

    def param_defs(self):
        raise NotImplementedError

    def prompt_inputs(self, params, batch):
        """(tokens, positions, embeds) for a whole-prompt chunk."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        return tokens, arange_positions(b, s, device=tokens.device), None

    @property
    def prefill_padding_ok(self) -> bool:
        return False


class DecoderLM(BaseLM):
    """Dense decoder-only LM over stacked layers."""

    def param_defs(self):
        defs = _embed_defs(self.cfg)
        defs["layers"] = stack_defs(layer_defs(self.cfg), self.cfg.n_layers)
        return defs

    def init_seq_state(self, params, max_len, *, batch=None,
                       batch_size=None, dtype="bfloat16", device=None):
        cfg = self.cfg
        b = batch_size if batch_size is not None else len(batch["tokens"])
        if device is None:
            device = params["embed"].device
        kv, hd, L = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
        shape = (L, b, max_len, kv, hd)
        dt = torch_dtype(dtype)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    def forward(self, params, state, tokens, positions, *, embeds=None,
                fresh=False, all_logits=False):
        """Advance ``state`` by one chunk; returns (state', logits (b, V)),
        or (b, T, V) with ``all_logits``."""
        if "block_tables" in state:
            return self._forward_paged(params, state, tokens, positions,
                                       all_logits=all_logits)
        cfg = self.cfg
        x = embeds if embeds is not None else self._embed(params, tokens)
        for i in range(cfg.n_layers):
            x = chunk_layer(cfg, layer_slice(params["layers"], i), x,
                            state["k"][i], state["v"][i], positions,
                            fresh=fresh)
        logits = self._chunk_logits(params, x, positions, all_logits)
        return state, logits

    def _forward_paged(self, params, state, tokens, positions,
                       all_logits=False):
        """Chunk forward against the block-paged pools (L, n_blocks, bs,
        kv, hd): one ``paged_chunk_attn`` per layer, write-then-attend
        with per-slot position masking, so decode ticks and prefill
        chunks are the same op.  Quantized pools carry per-token
        ``k_scale``/``v_scale`` (L, n_blocks, bs)."""
        cfg = self.cfg
        tables = state["block_tables"]
        quant = "k_scale" in state
        x = self._embed(params, tokens)
        slots = attn.paged_slot_index(tables, positions, state["k"].shape[2])
        for i in range(cfg.n_layers):
            x = paged_chunk_layer(
                cfg, layer_slice(params["layers"], i), x, state["k"][i],
                state["v"][i], tables, positions, slots,
                k_scale=state["k_scale"][i] if quant else None,
                v_scale=state["v_scale"][i] if quant else None)
        logits = self._chunk_logits(params, x, positions, all_logits)
        lengths = positions.max(dim=1).values.to(torch.int32) + 1
        return {**state, "lengths": lengths}, logits

    @property
    def prefill_padding_ok(self) -> bool:
        return True

    @property
    def paged_kv_layers(self) -> int:
        return self.cfg.n_layers


_NOT_PORTED = ("moe", "vlm", "hybrid", "ssm", "audio")


def build_model(cfg: ModelConfig) -> BaseLM:
    if cfg.family == "dense":
        return DecoderLM(cfg)
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to "
            f"repro_torch yet; only the dense family is")
    raise ValueError(cfg.family)


__all__ = ["BaseLM", "DecoderLM", "arange_positions", "build_model",
           "last_valid_index"]
