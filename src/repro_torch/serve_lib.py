"""Serving-side substrate (port of ``repro/serve_lib.py``): KV context
caching on disk (paper §VI-B4).

* ``KVContextCache``: content-addressed store of prefilled decode
  states (any family's cache tree) on a 3FS-KV namespace, keyed by a
  hash of the exact token prefix (and of a VLM's patches or Whisper's
  frames, which the state depends on too).
* ``BatchServer``: prefill-or-restore + greedy decode over request
  batches, with hit-rate accounting: the dense lockstep path against
  one contiguous SeqState, or the paged ``ServingEngine``.

Host arrays are torch CPU tensors.  A packed tree is what the JAX
package writes, byte for byte: leaves in ``jax.tree_util`` order (dict
keys sorted), each ``{"shape", "dtype", "data"}`` with the dtype spelled
as numpy spells it (``ckpt/manager.py:DTYPE_NAMES``, no ``ml_dtypes``),
packed by ``fs3/codec.py:packb`` (no ``msgpack``).
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.ckpt.manager import dtype_name, stored_dtype
from repro_torch.device import resolve_device
from repro_torch.fs3.codec import packb, unpackb
from repro_torch.telemetry import Registry, now, span


def _prefix_key(tokens: np.ndarray) -> str:
    """Prompt identity (sha256 of the int32 tokens, 32 hex chars): the
    paged prefix index, the 3FS prefix store and ``KVContextCache``
    share it."""
    h = hashlib.sha256(np.ascontiguousarray(tokens, np.int32).tobytes())
    return h.hexdigest()[:32]


def _batch_key(batch: dict) -> str:
    """Identity of a model-format prefill batch: ``_prefix_key`` of its
    tokens when they are the whole prompt; with a VLM's patches or
    Whisper's frames beside them, of the tokens and those arrays
    together (the prefilled state depends on both)."""
    extra = sorted(k for k in batch if k != "tokens")
    if not extra:
        return _prefix_key(batch["tokens"])
    h = hashlib.sha256(np.ascontiguousarray(batch["tokens"],
                                            np.int32).tobytes())
    for k in extra:
        a = np.ascontiguousarray(batch[k])
        h.update(f"{k}:{a.dtype.str}:{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()[:32]


def _np_dtype(name: str) -> torch.dtype:
    """The torch dtype of a stored dtype name, numpy's spelling
    (``bfloat16``, ``float8_e4m3fn`` included) through the port's own
    table."""
    return stored_dtype(name)


def _leaf_bytes(t) -> bytes:
    """A tensor's (or numpy array's) raw bytes, row-major."""
    t = torch.as_tensor(t).detach().cpu().contiguous()
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def _from_bytes(data: bytes, dtype: torch.dtype, shape) -> torch.Tensor:
    """A CPU tensor over a copy of ``data``."""
    if not data:
        return torch.empty(list(shape), dtype=dtype)
    raw = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    return raw.view(dtype).reshape(list(shape))


def _leaves(tree) -> list:
    """Leaves in ``jax.tree_util`` order: dict keys sorted, lists and
    tuples in order, None no leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _unflatten(template, leaves):
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return None if t is None else next(it)
    return walk(template)


def _host_tree(tree):
    """``tree`` with its tensors on the host and its dicts in sorted key
    order (what ``jax.device_get`` of a jitted function's output gives)."""
    if isinstance(tree, dict):
        return {k: _host_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v) for v in tree)
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def _tree_to(tree, device):
    """``tree`` with its tensors moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _pack_tree(tree) -> bytes:
    leaves = [torch.as_tensor(x) for x in _leaves(tree)]
    return packb({"n": len(leaves),
                  "leaves": [{"shape": list(x.shape),
                              "dtype": dtype_name(x.dtype),
                              "data": _leaf_bytes(x)} for x in leaves]})


def _unpack_tree(raw: bytes, template):
    """Leaves of ``raw`` in ``template``'s nesting, each cast to its
    template leaf's dtype on that leaf's device (a template on the
    ``meta`` device gives CPU tensors)."""
    payload = unpackb(raw)
    tmpl = _leaves(template)
    if payload["n"] != len(tmpl):
        raise ValueError(f"cache layout mismatch: {payload['n']} stored "
                         f"leaves, the template has {len(tmpl)}")
    out = []
    for rec, t in zip(payload["leaves"], tmpl):
        x = _from_bytes(rec["data"], _np_dtype(rec["dtype"]), rec["shape"])
        dev = "cpu" if t.device.type == "meta" else t.device
        out.append(x.to(device=dev, dtype=t.dtype))
    return _unflatten(template, out)


def grow_seq_state(state: dict, needed: int) -> dict:
    """Grow a SeqState's self-attention KV capacity (the 5-D "k" / "v"
    leaves, seq dim 2) geometrically to cover ``needed`` positions.
    Slack positions are masked by the per-position chunk attention, so
    outputs are unchanged; recurrent states are fixed size and left
    alone."""
    def grow(x):
        cur = x.shape[2]
        cap = max(cur, 1)
        while cap < needed:
            cap *= 2
        if cap > cur:
            return torch.nn.functional.pad(
                x, (0, 0, 0, 0, 0, cap - cur))
        return x
    out = dict(state)
    for key in ("k", "v"):
        if key in out and getattr(out[key], "ndim", 0) == 5:
            out[key] = grow(out[key])
    return out


class KVContextCache:
    def __init__(self, kv, namespace: str = "kvcache"):
        self.kv = kv            # repro_torch.fs3.FS3KV-compatible
        self.hits = 0
        self.misses = 0

    def get(self, batch: dict, template):
        """``batch``: the model-format prefill batch (host arrays: tokens,
        and a VLM's patches or Whisper's frames)."""
        raw = self.kv.get(_batch_key(batch))
        if raw is None:
            self.misses += 1
            return None
        self.hits += 1
        return _unpack_tree(raw, template)

    def put(self, batch: dict, cache) -> None:
        self.kv.put(_batch_key(batch), _pack_tree(cache))

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class BatchServer:
    """Prefill-or-restore + greedy decode for a batch of requests.

    Both paths drive the chunk API (``init_seq_state`` + ``forward``),
    selected by ``cfg.decode_impl`` or the ``decode_impl`` override:

    * ``"dense"``: lockstep decode against one contiguous SeqState (the
      prompt one fresh chunk, every decode step a T = 1 chunk); a
      ``KVContextCache`` hit restores the prefilled state instead;
    * ``"paged"``: the batch goes through ``serving.ServingEngine``
      (block-paged KV, continuous batching, block-reference prefix
      reuse).

    Runs on the card unless ``device="cpu"``."""

    def __init__(self, model, params, context_cache: KVContextCache | None,
                 *, gen_slots: int = 32, decode_impl: str | None = None,
                 engine_kwargs: dict | None = None, device=None):
        self.model = model
        self.params = params
        self.ctx = context_cache
        self.gen_slots = gen_slots
        self.device = resolve_device(device)
        self.decode_impl = decode_impl or getattr(
            getattr(model, "cfg", None), "decode_impl", "dense")
        self._engine = None
        self._engine_kwargs = engine_kwargs or {}
        self.metrics = Registry("batch_server")
        self._c_batches = self.metrics.counter("batch_server.batches")
        self._h_serve = self.metrics.histogram("batch_server.serve_s")
        # the dense path's request metrics (the paged path reports
        # through the engine's registry)
        self._c_completed = self.metrics.counter(
            "batch_server.requests_completed")
        self._h_ttft = self.metrics.histogram("batch_server.ttft_s")
        self._h_tpot = self.metrics.histogram("batch_server.tpot_s")

    @property
    def stats(self) -> dict:
        """The unified serving stats schema (``serving.stats``) plus the
        server's extras; after a paged run, the engine's stats are the
        base."""
        from repro_torch.serving.stats import serving_stats
        extras = {"batches": self._c_batches.value,
                  "serve_s": self._h_serve.snapshot(),
                  "hit_rate": self.ctx.hit_rate if self.ctx else 0.0}
        if self._engine is not None:
            s = dict(self._engine.stats)
            s.update(extras)
            s["hit_rate"] = self._engine.cache.hit_rate
            return s
        return serving_stats(
            requests_completed=self._c_completed.value,
            queue_depth=0,     # dense serve() is synchronous: no queue
            evictions=0, ttft=self._h_ttft, tpot=self._h_tpot, **extras)

    def _on_device(self, batch: dict) -> dict:
        """The model-format batch (tokens, and a VLM's patches or
        Whisper's frames) as tensors on the server's device."""
        out = {k: torch.as_tensor(np.asarray(v), device=self.device)
               for k, v in batch.items()}
        out["tokens"] = out["tokens"].to(torch.int32)
        return out

    def _serve_paged(self, batch: dict, gen: int):
        from repro_torch.serving import ServingEngine
        if self._engine is None:
            kw = dict(max_slots=self.gen_slots)
            kw.update(self._engine_kwargs)
            self._engine = ServingEngine(self.model, self.params,
                                         device=self.device, **kw)
        rids = [self._engine.submit(row, gen)
                for row in np.asarray(batch["tokens"])]
        outs = self._engine.run()
        return np.stack([outs[r] for r in rids]), self.stats

    def _template(self, batch: dict, gen: int):
        """(state, logits) of a prefill, shapes and dtypes only (on the
        ``meta`` device: Whisper's encoder does not run)."""
        b = batch["tokens"].shape[0]
        state = self.model.init_seq_state(
            self.params, self.model.prompt_length(batch) + gen, batch=batch,
            batch_size=b, device="meta")
        logits = torch.empty((b, self.model.cfg.vocab_size),
                             dtype=self.model.compute_dtype, device="meta")
        return state, logits

    def _prefill_state(self, batch: dict, gen: int):
        """One fresh whole-prompt chunk; capacity covers prompt + gen."""
        tok, positions, embeds = self.model.prompt_inputs(self.params,
                                                          batch)
        b, s = positions.shape
        state = self.model.init_seq_state(self.params, s + gen, batch=batch,
                                          batch_size=b, device=self.device)
        return self.model.forward(self.params, state, tok, positions,
                                  embeds=embeds, fresh=True)

    def serve(self, batch: dict, gen: int = 16):
        """batch: model-format prefill inputs ({"tokens": (b, s)}, and a
        VLM's "patches" or Whisper's "frames"); returns (tokens (b, gen),
        info)."""
        self._c_batches.inc()
        t0 = now()
        with span("batch_server.serve", impl=self.decode_impl, gen=gen):
            out = self._serve(batch, gen)
        self._h_serve.record(now() - t0)
        return out

    def _serve(self, batch: dict, gen: int):
        if self.decode_impl == "paged":
            return self._serve_paged(batch, gen)
        t0 = now()
        host = {k: np.asarray(v) for k, v in batch.items()}
        batch = self._on_device(host)
        b = host["tokens"].shape[0]
        start = self.model.prompt_length(batch)
        restored = None
        if self.ctx is not None:
            restored = self.ctx.get(host, self._template(batch, gen))
        if restored is None:
            state, logits = self._prefill_state(batch, gen)
            if self.ctx is not None:
                self.ctx.put(host, (state, logits))
        else:
            state, logits = _tree_to(restored, self.device)
        state = grow_seq_state(state, start + gen)

        toks = torch.argmax(logits, dim=-1).to(torch.int32)
        out = [toks.cpu().numpy()]
        t_last = now()
        for _ in range(b):       # lockstep: the batch shares one TTFT
            self._h_ttft.record(t_last - t0)
        for i in range(gen - 1):
            pos = torch.full((b, 1), start + i, dtype=torch.int32,
                             device=self.device)
            state, logits = self.model.forward(self.params, state,
                                               toks[:, None], pos)
            toks = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(toks.cpu().numpy())
            tnow = now()
            for _ in range(b):
                self._h_tpot.record(tnow - t_last)
            t_last = tnow
        self._c_completed.inc(b)
        info = {"hit_rate": self.ctx.hit_rate if self.ctx else 0.0}
        return np.stack(out, axis=1), info
