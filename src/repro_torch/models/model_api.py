"""Model API (port of ``repro/models/model_api.py``): the dense, MoE and
VLM decoder-only families, the Zamba2 hybrid, Whisper (encoder-decoder)
and xLSTM.

  loss(params, batch) -> (loss, {"ce", "aux_loss"})      training
  init_seq_state(params, max_len, ...) -> SeqState        serving
  forward(params, state, tokens, positions) -> (SeqState, logits)

``tokens`` is (b, T) for any T >= 1 (prompt, prefill chunk or decode
tick); ``positions`` (b, T) are absolute per-slot positions, negative =
padding (not written, skipped by the last-token logit gather).  A state
holding ``block_tables`` is a paged pool (``_forward_paged``); otherwise
it is a dense cache {k, v} of shape (L, b, S, kv, hd) (the hybrid's
also holds its per-layer mamba states, Whisper's the encoder's cross
K/V {xk, xv}); xLSTM's is its per-block recurrent states {blocks}.
Cache tensors are updated in place and returned in the new state.
Families with non-token inputs (VLM patches, Whisper frames) take them
in ``batch`` (``prompt_inputs``, ``init_seq_state``, ``loss``).

Parameter trees have the JAX package's keys and shapes, so
``bridge.params_from_numpy`` loads JAX-initialised weights directly.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.models import attention as attn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models import zamba as zamba_mod
from repro_torch.models.attention import _proj
from repro_torch.models.common import (apply_norm, cross_entropy, norm_defs,
                                       sinusoidal_pe, sinusoidal_positions)
from repro_torch.models.params import init_tree, p
from repro_torch.models.transformer import (_sub, attn_sublayer, chunk_layer,
                                            dense_layer, layer_defs,
                                            layer_slice, paged_chunk_layer,
                                            scan_layers, stack_defs)


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

    def _ce(self, params, x, labels, mask=None):
        return cross_entropy(self._logits(params, x), labels, mask)

    def param_defs(self):
        raise NotImplementedError

    def prompt_inputs(self, params, batch):
        """(tokens, positions, embeds) for a whole-prompt chunk."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        return tokens, arange_positions(b, s, device=tokens.device), None

    def prompt_length(self, batch) -> int:
        """Sequence positions a prompt occupies (VLM patches included):
        where decode continues from."""
        return batch["tokens"].shape[1]

    @property
    def prefill_padding_ok(self) -> bool:
        """Whether padding tokens (positions < 0) may ride through a
        chunk: True only when every sequence mixer is position-masked
        attention.  A carried recurrence (SSD) would absorb the padding
        into its state, so such families need exact-length chunks."""
        return False

    def _paged_chunk_driver(self, params, tokens, positions, step_token,
                            all_logits=False):
        """Per-token scaffolding for paged forwards of families with a
        carried recurrence (hybrid mamba states advance one token at a
        time): embed token t, run ``step_token(x, pos) -> x`` (which
        advances the pools / recurrent carries in its closure), then
        gather per-slot last-valid logits (or project every row with
        ``all_logits``).  Returns (logits, lengths)."""
        T = positions.shape[1]
        per_step = [step_token(self._embed(params, tokens[:, t])[:, None, :],
                               positions[:, t])
                    for t in range(T)]
        x = torch.cat(per_step, dim=1) if T > 1 else per_step[0]
        logits = self._chunk_logits(params, x, positions, all_logits)
        lengths = positions.max(dim=1).values.to(torch.int32) + 1
        return logits, lengths


class DecoderLM(BaseLM):
    """Dense / MoE / VLM decoder-only LM over stacked layers.  MoE layers
    replace the MLP with ``models.moe.apply_moe`` in groups of
    ``moe_group`` tokens: capacity-limited in training (its aux loss
    summed over the layers into the loss), dropless when serving.  The
    VLM prepends ``batch["patches"]`` (b, npatch, d), the stub frontend's
    patch embeddings, at positions 0 .. npatch - 1; its loss drops their
    rows."""

    def __init__(self, cfg: ModelConfig,
                 moe_group: int = moe_mod.DEFAULT_GROUP):
        super().__init__(cfg)
        self.is_moe = cfg.moe is not None
        self.is_vlm = cfg.family == "vlm"
        self.moe_group = moe_group

    def param_defs(self):
        defs = _embed_defs(self.cfg)
        defs["layers"] = stack_defs(layer_defs(self.cfg), self.cfg.n_layers)
        return defs

    # ---- forward over stacked layers (training) ----

    def _moe_layer(self, x, aux, lp):
        cfg = self.cfg
        x = attn_sublayer(cfg, lp, x, causal=True)
        h = apply_norm(cfg, _sub(lp, "ln2_"), x, name="norm")
        y, a = moe_mod.apply_moe(cfg, _sub(lp, "moe_"), h,
                                 group_size=self.moe_group)
        return x + y, aux + a

    def _forward(self, params, x, remat=True):
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.is_moe:
            fn = self._moe_layer
        else:
            def fn(h, a, lp):
                return dense_layer(cfg, lp, h, causal=True), a
        return scan_layers(fn, x, aux, params["layers"], remat=remat)

    def _serving_ffn(self):
        """The FFN of the serving layers: None (the dense MLP), or the
        dropless MoE without its aux loss, which serving drops."""
        if not self.is_moe:
            return None

        def ffn(lp, h):
            return moe_mod.apply_moe(self.cfg, _sub(lp, "moe_"), h,
                                     group_size=self.moe_group,
                                     dropless=True, _aux=False)[0]
        return ffn

    def _inputs(self, params, batch):
        x = self._embed(params, batch["tokens"])
        if self.is_vlm:
            patches = batch["patches"].to(self.compute_dtype)
            x = torch.cat([patches, x], dim=1)
        return x

    def loss(self, params, batch, remat=True):
        """batch {"tokens", "labels"[, "mask"]} (b, s) (the VLM's also
        "patches") -> (ce + aux, {"ce", "aux_loss"}); aux is the MoE
        layers' summed load-balance loss, a zero scalar for the dense
        family.  ``remat``: recompute each layer in the backward (see
        ``scan_layers``)."""
        x = self._inputs(params, batch)
        x, aux = self._forward(params, x, remat=remat)
        if self.is_vlm:
            x = x[:, self.cfg.n_frontend_tokens:]
        ce = self._ce(params, x, batch["labels"], batch.get("mask"))
        return ce + aux, {"ce": ce, "aux_loss": aux}

    def prompt_inputs(self, params, batch):
        if not self.is_vlm:
            return super().prompt_inputs(params, batch)
        x = self._inputs(params, batch)          # (b, npatch + s, d)
        b, t = x.shape[:2]
        return None, arange_positions(b, t, device=x.device), x

    def prompt_length(self, batch) -> int:
        npatch = self.cfg.n_frontend_tokens if self.is_vlm else 0
        return batch["tokens"].shape[1] + npatch

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
        ffn = self._serving_ffn()
        x = embeds if embeds is not None else self._embed(params, tokens)
        for i in range(cfg.n_layers):
            x = chunk_layer(cfg, layer_slice(params["layers"], i), x,
                            state["k"][i], state["v"][i], positions,
                            fresh=fresh, ffn=ffn)
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
        ffn = self._serving_ffn()
        x = self._embed(params, tokens)
        slots = attn.paged_slot_index(tables, positions, state["k"].shape[2])
        for i in range(cfg.n_layers):
            x = paged_chunk_layer(
                cfg, layer_slice(params["layers"], i), x, state["k"][i],
                state["v"][i], tables, positions, slots,
                k_scale=state["k_scale"][i] if quant else None,
                v_scale=state["v_scale"][i] if quant else None, ffn=ffn)
        logits = self._chunk_logits(params, x, positions, all_logits)
        lengths = positions.max(dim=1).values.to(torch.int32) + 1
        return {**state, "lengths": lengths}, logits

    @property
    def prefill_padding_ok(self) -> bool:
        return True

    @property
    def paged_kv_layers(self) -> int:
        return self.cfg.n_layers

    def paged_state_extras(self, n_slots: int, device=None) -> dict:
        return {}


class ZambaLM(BaseLM):
    """Mamba2 backbone with one shared attention+MLP block
    (``models.zamba``)."""

    def param_defs(self):
        defs = _embed_defs(self.cfg)
        defs.update(zamba_mod.zamba_defs(self.cfg))
        return defs

    def loss(self, params, batch, remat=True):
        """batch {"tokens", "labels"[, "mask"]} (b, s) -> (ce, {"ce"});
        ``remat`` as in ``zamba.zamba_forward``."""
        x = self._embed(params, batch["tokens"])
        x = zamba_mod.zamba_forward(self.cfg, params, x, remat=remat)
        ce = self._ce(params, x, batch["labels"], batch.get("mask"))
        return ce, {"ce": ce}

    def init_seq_state(self, params, max_len, *, batch=None,
                       batch_size=None, dtype="bfloat16", device=None):
        cfg = self.cfg
        b = batch_size if batch_size is not None else len(batch["tokens"])
        if device is None:
            device = params["embed"].device
        inv = zamba_mod.n_attn_invocations(cfg)
        shape = (inv, b, max_len, cfg.n_kv_heads, cfg.head_dim)
        dt = torch_dtype(dtype)
        return {"mamba": zamba_mod.zamba_mamba_init(cfg, b,
                                                    self.compute_dtype,
                                                    device),
                "k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    def forward(self, params, state, tokens, positions, *, embeds=None,
                fresh=False, all_logits=False):
        """Advance ``state`` by one chunk; returns (state', logits (b, V)),
        or (b, T, V) with ``all_logits``."""
        if "block_tables" in state:
            return self._forward_paged(params, state, tokens, positions,
                                       all_logits=all_logits)
        x = embeds if embeds is not None else self._embed(params, tokens)
        x, mamba_states = zamba_mod.zamba_chunk(self.cfg, params, x,
                                                positions, state,
                                                fresh=fresh)
        logits = self._chunk_logits(params, x, positions, all_logits)
        return {**state, "mamba": mamba_states}, logits

    def _forward_paged(self, params, state, tokens, positions,
                       all_logits=False):
        """Token by token against the paged pools (I, n_blocks, bs, kv,
        hd), written in place, and the per-slot mamba states in
        ``state["mamba"]``."""
        cfg = self.cfg
        tables = state["block_tables"]
        mamba = state["mamba"]

        def step_token(x, pos):
            nonlocal mamba
            x, mamba = zamba_mod.zamba_paged_step(
                cfg, params, x, mamba, state["k"], state["v"], tables, pos,
                state.get("k_scale"), state.get("v_scale"))
            return x

        logits, lengths = self._paged_chunk_driver(
            params, tokens, positions, step_token, all_logits=all_logits)
        return {**state, "mamba": mamba, "lengths": lengths}, logits

    @property
    def paged_kv_layers(self) -> int:
        return zamba_mod.n_attn_invocations(self.cfg)

    def paged_state_extras(self, n_slots: int, device=None) -> dict:
        """Per-slot mamba state pools riding beside the paged KV blocks —
        what lets the hybrid family join the paged path."""
        return {"mamba": zamba_mod.zamba_mamba_init(
            self.cfg, n_slots, self.compute_dtype, device)}


class WhisperLM(BaseLM):
    """Encoder-decoder (Whisper): the stub frontend's frame embeddings
    ``batch["frames"]`` (b, se, d) plus sinusoidal positions through a
    non-causal encoder, then a decoder whose layers cross-attend to the
    encoder output's per-layer K/V (``_cross_kv``).  Decoder tokens take
    sinusoidal embeddings at their per-slot positions.  The serving
    state holds the cross K/V {xk, xv} (L, b, se, kv, hd) beside the
    self-attention cache, computed once by ``init_seq_state``."""

    @property
    def prefill_padding_ok(self) -> bool:
        return True     # the decoder mixes only through masked attention

    def param_defs(self):
        cfg = self.cfg
        defs = _embed_defs(cfg)
        defs["encoder"] = stack_defs(layer_defs(cfg), cfg.encoder_layers)
        defs["enc_final"] = norm_defs(cfg)
        defs["decoder"] = stack_defs(layer_defs(cfg, cross_attention=True),
                                     cfg.n_layers)
        return defs

    def _encode(self, params, frames, remat=True):
        cfg = self.cfg
        cd = self.compute_dtype
        pos = sinusoidal_positions(frames.shape[1], cfg.d_model,
                                   device=frames.device)
        x = frames.to(cd) + pos.to(cd)

        def fn(h, aux, lp):
            return dense_layer(cfg, lp, h, causal=False), aux
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        x, _ = scan_layers(fn, x, aux, params["encoder"], remat=remat)
        return apply_norm(cfg, params["enc_final"], x, name="norm")

    def _cross_kv(self, params, enc):
        """The decoder layers' cross K/V of the encoder output, stacked:
        (L, b, se, kv, hd) each."""
        dec = params["decoder"]
        ks = [_proj(enc, w) for w in dec["xattn_wk"].unbind(0)]
        vs = [_proj(enc, w) for w in dec["xattn_wv"].unbind(0)]
        return torch.stack(ks), torch.stack(vs)

    def _decode_stack(self, params, x, xks, xvs, remat=True):
        cfg = self.cfg

        def fn(h, aux, lp):
            return dense_layer(cfg, lp, h, causal=True,
                               cross_kv=(lp["cross_k"], lp["cross_v"])), aux
        # each layer's cross K/V ride in the stacked tree, split with its
        # params (no prefix of dense_layer's reads them)
        layers = {**params["decoder"], "cross_k": xks, "cross_v": xvs}
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return scan_layers(fn, x, aux, layers, remat=remat)[0]

    def _dec_inputs(self, params, tokens, positions):
        """Token embeddings + sinusoidal embeddings at per-slot
        positions."""
        x = self._embed(params, tokens)
        return x + sinusoidal_pe(positions, self.cfg.d_model).to(x.dtype)

    def loss(self, params, batch, remat=True):
        """batch {"frames" (b, se, d), "tokens", "labels"[, "mask"] (b,
        s)} -> (ce, {"ce"}); ``remat`` recomputes each encoder and decoder
        layer in the backward."""
        enc = self._encode(params, batch["frames"], remat=remat)
        xks, xvs = self._cross_kv(params, enc)
        b, s = batch["tokens"].shape
        x = self._dec_inputs(params, batch["tokens"],
                             arange_positions(b, s, device=enc.device))
        x = self._decode_stack(params, x, xks, xvs, remat=remat)
        ce = self._ce(params, x, batch["labels"], batch.get("mask"))
        return ce, {"ce": ce}

    def init_seq_state(self, params, max_len, *, batch=None,
                       batch_size=None, dtype="bfloat16", device=None):
        """Runs the encoder on ``batch["frames"]`` and keeps the cross
        K/V.  On the ``meta`` device (a restore template) only the
        shapes are made: the encoder does not run."""
        cfg = self.cfg
        if batch is None or "frames" not in batch:
            raise ValueError("Whisper's init_seq_state needs "
                             "batch['frames'] for the encoder")
        frames = batch["frames"]
        b, se = frames.shape[0], frames.shape[1]
        if device is None:
            device = params["embed"].device
        kv, hd, L = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
        dt = torch_dtype(dtype)
        if torch.device(device).type == "meta":
            xks = xvs = torch.empty((L, b, se, kv, hd), dtype=dt,
                                    device=device)
        else:
            enc = self._encode(params, frames.to(device), remat=False)
            xks, xvs = self._cross_kv(params, enc)
        shape = (L, b, max_len, kv, hd)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device),
                "xk": xks.to(dt), "xv": xvs.to(dt)}

    def forward(self, params, state, tokens, positions, *, embeds=None,
                fresh=False, all_logits=False):
        """Advance ``state`` by one decoder chunk; returns (state',
        logits (b, V)), or (b, T, V) with ``all_logits``."""
        cfg = self.cfg
        x = embeds if embeds is not None else self._dec_inputs(
            params, tokens, positions)
        for i in range(cfg.n_layers):
            x = chunk_layer(cfg, layer_slice(params["decoder"], i), x,
                            state["k"][i], state["v"][i], positions,
                            fresh=fresh,
                            cross_kv=(state["xk"][i], state["xv"][i]))
        logits = self._chunk_logits(params, x, positions, all_logits)
        return state, logits


class XLSTMLM(BaseLM):
    """xLSTM: blocks ``block_i`` of ``cfg.block_pattern`` ("m": mLSTM,
    "s": sLSTM; ``models.xlstm``), no attention.  The serving state is
    the per-block recurrent states {blocks}; a prompt is exact-length
    chunks (padding would enter the recurrences)."""

    def param_defs(self):
        cfg = self.cfg
        defs = _embed_defs(cfg)
        for i, kind in enumerate(cfg.block_pattern):
            defs[f"block_{i}"] = (xlstm_mod.mlstm_block_defs(cfg)
                                  if kind == "m" else
                                  xlstm_mod.slstm_block_defs(cfg))
        return defs

    def loss(self, params, batch, remat=True):
        """batch {"tokens", "labels"[, "mask"]} (b, s) -> (ce, {"ce"});
        ``remat`` recomputes each block in the backward."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        for i, kind in enumerate(cfg.block_pattern):
            fn = (xlstm_mod.apply_mlstm_block if kind == "m"
                  else xlstm_mod.apply_slstm_block)
            blk = params[f"block_{i}"]
            if remat and torch.is_grad_enabled():
                x = checkpoint(fn, cfg, blk, x, use_reentrant=False)
            else:
                x = fn(cfg, blk, x)
        ce = self._ce(params, x, batch["labels"], batch.get("mask"))
        return ce, {"ce": ce}

    def init_seq_state(self, params, max_len, *, batch=None,
                       batch_size=None, dtype="bfloat16", device=None):
        """Fixed-size recurrent states (``max_len`` and ``dtype`` unused:
        the conv window keeps the compute dtype, the cells fp32)."""
        b = batch_size if batch_size is not None else len(batch["tokens"])
        if device is None:
            device = params["embed"].device
        return {"blocks": xlstm_mod.xlstm_init_states(
            self.cfg, b, self.compute_dtype, device)}

    def forward(self, params, state, tokens, positions, *, embeds=None,
                fresh=False, all_logits=False):
        """Advance ``state`` by one exact-length chunk (T = 1: a decode
        step); returns (state', logits)."""
        cfg = self.cfg
        x = embeds if embeds is not None else self._embed(params, tokens)
        decode = x.shape[1] == 1 and not fresh
        new_states = []
        for i, kind in enumerate(cfg.block_pattern):
            blk = params[f"block_{i}"]
            st = None if fresh else state["blocks"][i]
            if kind == "m":
                fn = (xlstm_mod.mlstm_block_decode if decode
                      else xlstm_mod.mlstm_block_prefill)
            else:
                fn = (xlstm_mod.slstm_block_decode if decode
                      else xlstm_mod.slstm_block_prefill)
            x, st = fn(cfg, blk, x, st)
            new_states.append(st)
        logits = self._chunk_logits(params, x, positions, all_logits)
        return {**state, "blocks": new_states}, logits


def build_model(cfg: ModelConfig, *, moe_group: int | None = None) -> BaseLM:
    """The model of ``cfg.family``; ``moe_group``: the MoE dispatch group
    size (default ``models.moe.DEFAULT_GROUP``)."""
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg, moe_group=moe_group or moe_mod.DEFAULT_GROUP)
    if cfg.family == "audio":
        return WhisperLM(cfg)
    if cfg.family == "hybrid":
        return ZambaLM(cfg)
    if cfg.family == "ssm":
        return XLSTMLM(cfg)
    raise ValueError(cfg.family)


__all__ = ["BaseLM", "DecoderLM", "WhisperLM", "XLSTMLM", "ZambaLM",
           "arange_positions", "build_model", "last_valid_index"]
