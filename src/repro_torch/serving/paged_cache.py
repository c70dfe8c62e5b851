"""Paged KV cache: fixed-size blocks, block tables, refcounted sharing
(port of ``repro/serving/paged_cache.py``).

The decode KV cache lives in two device pools of shape (layers,
n_blocks, block_size, kv_heads, head_dim); a sequence owns an ordered
list of physical block ids and logical position ``p`` lives at block
``table[p // bs]``, offset ``p % bs``.  Host-side around the pools:

* a LIFO free list over block ids 1..n_blocks-1 — block 0 is scratch:
  idle engine slots point their tables (and their token writes) at it;
* refcounts — a block rejoins the free list when its last owner drops
  it, which makes prefix sharing safe;
* a prefix index — hash(prompt) -> (block ids, length, first greedy
  token, extras).  A hit shares the full blocks by reference and copies
  only the trailing partial block (copy-on-write); ``extras`` is the
  non-KV state after the prompt (the hybrid's mamba states), which
  blocks cannot reconstruct.

``rollback`` truncates a sequence's table after a speculative verify
(host bookkeeping only); ``export_blocks`` / ``import_blocks`` move
block contents (with the scale rows of quantized pools, raw codes, no
requantization) between pools as host tensors, the wire format of the
cluster's prefill -> decode handoff and of its 3FS prefix store; an
``on_prefix_evict`` hook publishes an LRU-dropped prefix entry before
its blocks are freed.

Pool writes are in place: where the JAX cache rebinds donated buffers,
the port updates its one copy.  Quantized pools (float8_e4m3, int8)
carry per-token fp32 scales (layers, n_blocks, bs) beside them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models.attention import KV_DTYPES, bits, quantize_kv
# one prefix identity across the serving stack: the paged index, the 3FS
# prefix store and the context cache agree on what "same prompt" means
from repro_torch.serve_lib import _prefix_key


class PagedKVCache:
    """Device block pools + host allocator/refcounts/prefix index."""

    def __init__(self, *, layers: int, n_blocks: int, block_size: int,
                 kv_heads: int, head_dim: int, dtype: str = "bfloat16",
                 kv_dtype: str | None = None, device=None):
        if n_blocks < 2:
            raise ValueError("need at least scratch + 1 allocatable block")
        self.device = resolve_device(device)
        pool_dtype = (KV_DTYPES[kv_dtype] if kv_dtype is not None
                      else torch_dtype(dtype))
        self.quantized = pool_dtype not in (torch.bfloat16, torch.float32)
        shape = (layers, n_blocks, block_size, kv_heads, head_dim)
        self.k = torch.zeros(shape, dtype=pool_dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=pool_dtype, device=self.device)
        if self.quantized:
            sshape = (layers, n_blocks, block_size)
            self.k_scale = torch.ones(sshape, dtype=torch.float32,
                                      device=self.device)
            self.v_scale = torch.ones(sshape, dtype=torch.float32,
                                      device=self.device)
        else:
            self.k_scale = None
            self.v_scale = None
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.refcount = np.zeros(n_blocks, np.int64)
        self.refcount[0] = 1                       # scratch, never freed
        self._free = list(range(n_blocks - 1, 0, -1))   # pop() -> low ids
        # key -> (block ids, length, first greedy token, extras)
        self._prefix: dict[str, tuple] = {}
        self._prefix_lru: list[str] = []
        self.hits = 0
        self.misses = 0
        # cluster hook: on_prefix_evict(key, ids, length, first_token,
        # extras), called before an LRU-dropped prefix entry's blocks are
        # freed (the engine publishes them to the 3FS prefix store)
        self.on_prefix_evict = None

    # ------------------------------ allocator ------------------------------

    @property
    def num_free(self) -> int:
        return len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def alloc(self, n: int) -> list[int] | None:
        """n fresh blocks at refcount 1, or None if the pool is
        exhausted (the caller reclaims prefixes, evicts, or waits)."""
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        self.refcount[ids] = 1
        return ids

    def incref(self, ids) -> None:
        for i in ids:
            self.refcount[i] += 1

    def free(self, ids) -> None:
        """Drop one reference per id; blocks at 0 rejoin the free list
        (stale K/V needs no scrubbing: readers mask by position)."""
        for i in ids:
            if self.refcount[i] <= 0:
                raise RuntimeError(f"double free of block {i}")
            self.refcount[i] -= 1
            if self.refcount[i] == 0:
                self._free.append(i)

    def rollback(self, blocks: list, n_tokens: int) -> list:
        """Truncate a sequence's block table to cover exactly ``n_tokens``
        cached positions, dropping one reference on each block past
        ``blocks_for(n_tokens)`` (a speculative verify wrote K/V past the
        accepted position).  Host bookkeeping only: stale entries inside
        the kept tail block are masked by length and later overwritten
        (``quantize_kv`` is a pure function of the value, so a rewritten
        fp8 / int8 entry and its scale are bit-identical).  Shared or
        copy-on-write blocks before the boundary keep their references.
        Returns the truncated table (a new list)."""
        keep = self.blocks_for(n_tokens)
        if keep >= len(blocks):
            return list(blocks)
        self.free(blocks[keep:])
        return list(blocks[:keep])

    # ---------------------------- device writes ----------------------------

    def write_prompt(self, k, v, block_ids) -> None:
        """Write fresh prefill K/V (L, s, kv, hd) into ``block_ids``
        (quantized with per-token scales for sub-bf16 pools)."""
        L, s, kvh, hd = k.shape
        bs = self.block_size
        pad = -s % bs
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        ids = torch.as_tensor(block_ids, dtype=torch.long,
                              device=self.device)
        if self.quantized:
            kq, ks = quantize_kv(k, self.k.dtype)
            vq, vs = quantize_kv(v, self.v.dtype)
            bits(self.k)[:, ids] = bits(kq).reshape(L, -1, bs, kvh, hd)
            bits(self.v)[:, ids] = bits(vq).reshape(L, -1, bs, kvh, hd)
            self.k_scale[:, ids] = ks.reshape(L, -1, bs)
            self.v_scale[:, ids] = vs.reshape(L, -1, bs)
        else:
            self.k[:, ids] = k.reshape(L, -1, bs, kvh, hd).to(self.k.dtype)
            self.v[:, ids] = v.reshape(L, -1, bs, kvh, hd).to(self.v.dtype)

    def export_blocks(self, block_ids) -> dict:
        """The contents of ``block_ids`` as host tensors ``{"k", "v"[,
        "k_scale", "v_scale"]}`` shaped (L, n, bs, ...): quantized pools
        give their raw codes with the per-token scale rows, so an import
        is bit-identical."""
        ids = torch.as_tensor(list(block_ids), dtype=torch.long,
                              device=self.device)
        out = {"k": self.k[:, ids].cpu(), "v": self.v[:, ids].cpu()}
        if self.quantized:
            out["k_scale"] = self.k_scale[:, ids].cpu()
            out["v_scale"] = self.v_scale[:, ids].cpu()
        return out

    def import_blocks(self, block_ids, data: dict) -> None:
        """Write exported block contents (tensors or numpy arrays) into
        ``block_ids`` of this pool (the caller allocates).  Quantized
        pools take their codes in the pool's dtype and bit for bit, never
        cast (an unclipped cast to e4m3 overflows), with their scale
        rows."""
        L, _, bs, kvh, hd = self.k.shape
        kb = torch.as_tensor(data["k"])
        if kb.shape[0] != L or tuple(kb.shape[2:]) != (bs, kvh, hd):
            raise ValueError(
                f"imported blocks {tuple(kb.shape)} do not fit pool layout "
                f"(L={L}, bs={bs}, kv={kvh}, hd={hd})")
        if len(block_ids) != kb.shape[1]:
            raise ValueError(f"{len(block_ids)} target blocks for "
                             f"{kb.shape[1]} imported blocks")
        ids = torch.as_tensor(list(block_ids), dtype=torch.long,
                              device=self.device)
        names = ("k", "v", "k_scale", "v_scale") if self.quantized \
            else ("k", "v")
        if self.quantized and "k_scale" not in data:
            raise ValueError("quantized pool import needs scale rows")
        for name in names:
            pool = getattr(self, name)
            src = torch.as_tensor(data[name])
            if src.dtype != pool.dtype:
                if self.quantized:
                    raise ValueError(f"quantized pool import: {name} is "
                                     f"{src.dtype}, the pool {pool.dtype}")
                src = src.to(pool.dtype)
            bits(pool)[:, ids] = bits(src).to(self.device)

    def copy_block(self, src: int) -> int | None:
        """Copy-on-write: duplicate one block (and its scale rows) into
        a fresh allocation."""
        dst = self.alloc(1)
        if dst is None:
            return None
        d = dst[0]
        bits(self.k)[:, d] = bits(self.k)[:, src]
        bits(self.v)[:, d] = bits(self.v)[:, src]
        if self.quantized:
            self.k_scale[:, d] = self.k_scale[:, src]
            self.v_scale[:, d] = self.v_scale[:, src]
        return d

    # --------------------------- prefix sharing ----------------------------

    def register_prefix(self, tokens: np.ndarray, block_ids, length: int,
                        first_token: int, extras=None) -> None:
        """Pin ``block_ids`` (incref) under the prompt's hash so later
        identical prompts restore by reference; ``first_token`` is the
        greedy continuation and ``extras`` the non-KV sequence state
        (None for attention-only families), neither of which the blocks
        can reconstruct."""
        key = _prefix_key(tokens)
        if key in self._prefix:
            return
        self.incref(block_ids)
        self._prefix[key] = (tuple(block_ids), length, first_token, extras)
        self._prefix_lru.append(key)

    def lookup_prefix(self, tokens: np.ndarray):
        """Exact-prompt hit -> (block_ids, length, first_token, extras)
        with the new sequence holding its own references; None on a
        miss.  Full blocks are shared; a partial trailing block is
        copied, because the restored sequence appends into it."""
        key = _prefix_key(tokens)
        ent = self._prefix.get(key)
        if ent is None:
            self.misses += 1
            return None
        ids, length, first_token, extras = ent
        if length % self.block_size == 0:
            self.incref(ids)
            blocks = list(ids)
        else:
            tail = self.copy_block(ids[-1])
            if tail is None:
                self.reclaim(1, keep=(key,))
                tail = self.copy_block(ids[-1])
            if tail is None:
                self.misses += 1
                return None
            self.incref(ids[:-1])
            blocks = list(ids[:-1]) + [tail]
        self.hits += 1
        self._prefix_lru.remove(key)          # refresh LRU position
        self._prefix_lru.append(key)
        return blocks, length, first_token, extras

    def _drop_prefix_entry(self, key: str) -> None:
        """Release one prefix entry, publishing it through
        ``on_prefix_evict`` while its blocks are still readable."""
        self._prefix_lru.remove(key)
        ids, length, first, extras = self._prefix.pop(key)
        if self.on_prefix_evict is not None:
            self.on_prefix_evict(key, ids, length, first, extras)
        self.free(ids)

    def reclaim(self, n_blocks: int, *, keep: tuple = ()) -> bool:
        """Release LRU prefix entries until ``n_blocks`` are allocatable;
        entries named in ``keep`` are spared."""
        while self.num_free < n_blocks:
            key = next((k for k in self._prefix_lru if k not in keep), None)
            if key is None:
                break
            self._drop_prefix_entry(key)
        return self.num_free >= n_blocks

    def drop_prefixes(self) -> int:
        """Release every prefix entry, each published through
        ``on_prefix_evict`` first (the cluster's write-back flush to the
        3FS store); returns the number dropped."""
        keys = list(self._prefix_lru)
        for key in keys:
            self._drop_prefix_entry(key)
        return len(keys)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
