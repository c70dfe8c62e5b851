"""Cluster-wide prefix cache: exported KV blocks in 3FS-KV (port of
``repro/serving/prefix_store.py``).

Each ``ServingEngine`` keeps a per-pool prefix index; ``FS3PrefixStore``
is the tier below it.  When an engine's LRU drops a prefix entry its
blocks are published here (write-back through the cache's
``on_prefix_evict`` hook), and any replica's cold prefill first tries
``fetch``: a prefix computed on replica 0 is a hit on replica 1.

Keys: the ``prefix_{tag}`` namespace (``prefix`` without a tag) and the
``serve_lib._prefix_key`` content hash.  ``tag`` names everything that
makes blocks non-portable (params, kv_dtype, block size); a new tag
leaves stale entries unreachable.

Values are msgpack (``fs3/codec.py``) with self-describing arrays
``{"__nd__": True, "shape", "dtype", "data"}``, the dtype as numpy
spells it: an artifact's bytes equal the JAX package's
``msgpack.packb(_enc(artifact))`` for the same contents, and quantized
pools' raw codes and fp32 scale rows round-trip byte for byte.
Decoded arrays are CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.ckpt.manager import dtype_name
from repro_torch.fs3.codec import packb, unpackb
from repro_torch.serve_lib import _from_bytes, _leaf_bytes, _np_dtype


def _enc(obj):
    """Recursively encode dicts, lists, scalars, tensors and numpy
    arrays for msgpack."""
    if isinstance(obj, dict):
        return {k: _enc(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_enc(v) for v in obj]
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        t = torch.as_tensor(obj)
        return {"__nd__": True, "shape": list(t.shape),
                "dtype": dtype_name(t.dtype), "data": _leaf_bytes(t)}
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj


def _dec(obj):
    if isinstance(obj, dict):
        if obj.get("__nd__"):
            return _from_bytes(obj["data"], _np_dtype(obj["dtype"]),
                               obj["shape"])
        return {k: _dec(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_dec(v) for v in obj]
    return obj


class FS3PrefixStore:
    """``publish(key, artifact)`` / ``fetch(key) -> artifact | None`` on
    an ``FS3KV``-compatible store; ``artifact`` is ``{"length",
    "first_token", "blocks": {...}, "extras": {...}}`` as the engine's
    publish path builds it."""

    def __init__(self, kv, tag: str = ""):
        self.kv = kv
        self.tag = tag
        self.publishes = 0
        self.hits = 0
        self.misses = 0

    def _path(self, key: str) -> str:
        return f"prefix_{self.tag}/{key}" if self.tag else f"prefix/{key}"

    def publish(self, key: str, artifact: dict) -> None:
        self.kv.put(self._path(key), packb(_enc(artifact)))
        self.publishes += 1

    def fetch(self, key: str):
        raw = self.kv.get(self._path(key))
        if raw is None:
            self.misses += 1
            return None
        self.hits += 1
        return _dec(unpackb(raw))

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
