"""Continuous-batching engine over the paged KV cache (port of
``repro/serving/engine.py``).

``ServingEngine`` keeps ``max_slots`` decode slots and a FIFO queue.
Each ``step``:

1. advances an in-flight chunked prefill by one chunk, then **admits**
   queued requests into free slots — prefilling the prompt into a dense
   scratch SeqState (or restoring it by block reference on a prefix
   hit) and writing the K/V into freshly allocated pool blocks;
2. runs **one T = 1 chunk for every occupied slot** through
   ``model.forward`` on the paged SeqState (per-slot lengths and block
   tables inside the state), which writes each slot's new K/V in place;
3. picks the next token per slot (greedy argmax, or temperature/top-k
   sampling) and retires finished requests, freeing their blocks.

Shapes follow the JAX engine so that both produce the same numbers: the
block-table width and the prefill capacity are bucketed to powers of
two, and attention-only families pad prompts to their bucket (position
-1).  The hybrid family, whose carried mamba recurrence would absorb
padding, prefills in exact-length chunks instead, and its per-slot
mamba states ride beside the paged KV blocks in the engine's extras
pools (``model.paged_state_extras``): a finished prefill scatters its
states into the slot, every decode tick carries them in the paged
SeqState and reads them back, and a prefix hit restores them.  Eager
PyTorch compiles nothing, so the JAX engine's trace counters have no
meaning here; ``prefill_traces`` / ``decode_traces`` now count the
distinct chunk shapes each path ran, which is what a captured-graph
cache would have to hold.

Eviction (``evict(rid)`` or pool exhaustion mid-decode) frees a running
request's blocks and re-queues it; decode is deterministic given
(seed, rid, position), so the replay reproduces the same tokens.

Speculative decoding (``spec_mode``): a drafter proposes up to
``draft_k`` tokens a slot, one (max_slots, draft_k + 1) chunk verifies
them through the paged kernel (``_spec_step``), the longest accepted
prefix plus a bonus token is emitted, the rejected tail's block
references are dropped (``PagedKVCache.rollback``) and, for the hybrid,
the mamba extras are re-advanced from the pre-verify snapshot through
the accepted rows only.

Disaggregation: a ``prefill_role`` engine runs prompts to their first
token with ``keep_blocks`` and hands them off (``export_request``: block
contents, scale rows, extras, the first token, as host tensors); a
decode engine imports them (``submit_prefilled``) and never runs the
prompt.  With a ``prefix_store`` (``serving.prefix_store``), prefix
entries the LRU drops are published to 3FS and a local miss first tries
the store.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.serve_lib import _host_tree, _prefix_key
from repro_torch.serving.paged_cache import PagedKVCache
from repro_torch.serving.speculative import (longest_accept, make_drafter,
                                             spec_accept)
from repro_torch.serving.stats import serving_stats
from repro_torch.telemetry import Registry, now, span

_PAGED_FAMILIES = ("dense", "moe", "hybrid")
_MASK64 = (1 << 63) - 1


def _scatter_slot(pools, one, slot: int) -> None:
    """Copy a batch-1 state tree ``one`` into row ``slot`` of the
    matching per-slot pool tree, in place."""
    if isinstance(pools, dict):
        for k in pools:
            _scatter_slot(pools[k], one[k], slot)
    elif isinstance(pools, (list, tuple)):
        for p_, o in zip(pools, one):
            _scatter_slot(p_, o, slot)
    else:
        pools[slot].copy_(one[0])


def _pow2_at_least(n: int, floor: int = 1) -> int:
    w = max(floor, 1)
    while w < n:
        w *= 2
    return w


def sample_seed(seed: int, rid: int, position: int) -> int:
    """The generator seed of the token a request samples at
    ``position``: a function of (seed, rid, position) only, so eviction
    replay resamples identically while same-prompt requests decorrelate
    by rid (splitmix64 over the three)."""
    x = (seed * 0x9E3779B97F4A7C15 + rid * 0xBF58476D1CE4E5B9
         + position * 0x94D049BB133111EB) & ((1 << 64) - 1)
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & ((1 << 64) - 1)
    x ^= x >> 31
    return x & _MASK64


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                 # (s,) int32 token ids
    max_new_tokens: int
    arrival: int = 0                   # earliest admissible engine step
    rid: int = -1
    # -- sampling (greedy when temperature == 0) --
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    # -- runtime state (engine-owned) --
    tokens: list = dataclasses.field(default_factory=list)   # generated
    blocks: list = dataclasses.field(default_factory=list)   # block table
    length: int = 0                    # cache occupancy (tokens written)
    slot: int = -1
    admitted_at: int = -1
    status: str = "queued"             # queued | prefilling | running | done
    # -- cluster handoff (prefill/decode disaggregation) --
    keep_blocks: bool = False          # retain blocks at done for export
    artifact: dict | None = None       # imported prefill (skips prefill)
    export_extras: dict | None = None  # non-KV state stashed for export
    # -- telemetry (host clock; recorded at completion) --
    # TTFT start: the start of the engine step at which the request
    # arrives (``arrival``), not the submit() call, so that requests
    # submitted ahead of their arrival step do not count the wait
    t_submit: float | None = None
    t_admit: float | None = None
    t_first: float | None = None       # first token exists (TTFT endpoint)
    t_last: float | None = None        # previous token (TPOT interval base)
    n_evictions: int = 0
    tpot_sum: float = 0.0
    tpot_n: int = 0

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


class _PrefillJob:
    """An in-flight chunked prefill: one chunk advances per engine step,
    interleaved with decode ticks.  Pool blocks are reserved up front."""

    def __init__(self, req, state, chunks, blocks):
        self.req = req
        self.state = state
        self.chunks = chunks           # list of (tokens, positions) tensors
        self.blocks = blocks
        self.next = 0
        self.logits = None

    @property
    def finished(self) -> bool:
        return self.next >= len(self.chunks)


class ServingEngine:
    def __init__(self, model, params, *, n_blocks: int = 256,
                 block_size: int = 16, max_slots: int = 4,
                 pool_dtype: str = "bfloat16", share_prefixes: bool = True,
                 min_table_width: int = 2, prefill_chunk: int = 0,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 kv_dtype: str | None = None, prefill_role: bool = False,
                 prefix_store=None, spec_mode: str = "off",
                 draft_k: int = 4, draft_model=None, draft_params=None,
                 draft_max_len: int = 512, ngram_max: int = 3,
                 ngram_min: int = 1, device=None):
        cfg = model.cfg
        if cfg.family not in _PAGED_FAMILIES:
            raise ValueError(f"paged serving of family {cfg.family!r} is "
                             f"not ported")
        self.device = resolve_device(device)
        self.pad_prefill = model.prefill_padding_ok
        self.model = model
        self.params = params
        self.cfg = cfg
        self.max_slots = max_slots
        self.share_prefixes = share_prefixes
        self.min_table_width = min_table_width
        self.prefill_chunk = prefill_chunk
        # disaggregation: a prefill-role replica runs prompts to their
        # first token and keeps the blocks for export_request(); its
        # chunked prefill advances with no running decode slot.  A
        # prefix_store makes locally dropped prefixes restorable by any
        # replica.
        self.prefill_role = prefill_role
        self.prefix_store = prefix_store
        self.temperature = temperature
        self.top_k = top_k
        self.seed = seed
        self.cache = PagedKVCache(
            layers=model.paged_kv_layers, n_blocks=n_blocks,
            block_size=block_size, kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, dtype=pool_dtype, kv_dtype=kv_dtype,
            device=self.device)
        # non-KV per-slot sequence state (hybrid mamba); {} otherwise
        self._extras = model.paged_state_extras(max_slots,
                                                device=self.device)
        self._extras_keys = tuple(self._extras)
        # speculation: "off" keeps the plain one-token tick
        self.spec_mode = spec_mode
        self.draft_k = int(draft_k)
        self.drafter = make_drafter(
            spec_mode, ngram_max=ngram_max, ngram_min=ngram_min,
            draft_model=draft_model, draft_params=draft_params,
            draft_max_len=draft_max_len, target_vocab=cfg.vocab_size)
        if self.drafter is not None and self.draft_k < 1:
            raise ValueError("draft_k must be >= 1 when speculating")

        self.metrics = Registry("engine")
        self._c_evictions = self.metrics.counter("engine.evictions")
        self._c_completed = self.metrics.counter("engine.requests_completed")
        self._h_ttft = self.metrics.histogram("engine.ttft_s")
        self._h_tpot = self.metrics.histogram("engine.tpot_s")
        self._h_queue = self.metrics.histogram("engine.queue_wait_s")
        self._c_store_hits = self.metrics.counter("engine.store_hits")
        # speculation: tokens emitted per slot per verify chunk (1..k+1)
        # and each chunk's accepted share of the proposed drafts
        self._h_spec_tps = self.metrics.histogram(
            "engine.spec_tokens_per_step")
        self._h_spec_acc = self.metrics.histogram("engine.spec_accept_rate")
        if prefix_store is not None:
            # write-back: LRU-dropped prefix entries publish to the
            # cluster store while their blocks are still readable
            self.cache.on_prefix_evict = self._publish_prefix
        self._prefill_shapes: set = set()
        self._decode_shapes: set = set()

        self._slots: list[Request | None] = [None] * max_slots
        self._queue: list[Request] = []
        self._done: dict[int, Request] = {}
        self._job: _PrefillJob | None = None
        self._next_rid = 0
        self._admission_seq = 0    # monotone: exact FIFO eviction priority
        self.step_count = 0
        self._request_log: list[dict] = []
        self._request_log_cap = 10_000

    @property
    def prefill_traces(self) -> int:
        return len(self._prefill_shapes)

    @property
    def decode_traces(self) -> int:
        return len(self._decode_shapes)

    @property
    def evictions(self) -> int:
        return self._c_evictions.value

    # ------------------------------- intake --------------------------------

    def submit(self, prompt, max_new_tokens: int, arrival: int = 0,
               temperature: float | None = None, top_k: int | None = None,
               seed: int | None = None, *, keep_blocks: bool = False,
               t_submit: float | None = None) -> int:
        """Queue a request.  ``keep_blocks`` keeps its pool blocks at
        completion for ``export_request`` (the cluster's prefill leg,
        with ``max_new_tokens=1``); ``t_submit`` carries the TTFT start
        of a multi-engine pipeline (default: the start of the step at
        which the request arrives)."""
        if t_submit is None and arrival <= self.step_count:
            t_submit = now()
        req = Request(prompt=np.asarray(prompt, np.int32).reshape(-1),
                      max_new_tokens=max_new_tokens, arrival=arrival,
                      temperature=self.temperature if temperature is None
                      else temperature,
                      top_k=self.top_k if top_k is None else top_k,
                      seed=self.seed if seed is None else seed,
                      rid=self._next_rid, keep_blocks=keep_blocks,
                      t_submit=t_submit)
        self._next_rid += 1
        self._queue.append(req)
        return req.rid

    def submit_prefilled(self, artifact: dict, max_new_tokens: int,
                         arrival: int = 0, temperature: float | None = None,
                         top_k: int | None = None,
                         seed: int | None = None) -> int:
        """Queue a request whose prompt KV arrives as a handoff artifact
        (``export_request``): admission imports the blocks instead of
        prefilling, so this engine never runs the prompt (the decode leg
        of a disaggregated cluster).  The TTFT start is the artifact's
        ``t_submit`` (now when it has none; 0.0 is a time)."""
        req = Request(prompt=np.asarray(artifact["prompt"],
                                        np.int32).reshape(-1),
                      max_new_tokens=max_new_tokens, arrival=arrival,
                      temperature=self.temperature if temperature is None
                      else temperature,
                      top_k=self.top_k if top_k is None else top_k,
                      seed=self.seed if seed is None else seed,
                      rid=self._next_rid, artifact=artifact,
                      t_submit=(now() if artifact.get("t_submit") is None
                                else artifact["t_submit"]))
        self._next_rid += 1
        self._queue.append(req)
        return req.rid

    # ------------------------------ sampling -------------------------------

    def _sample(self, req: Request, logits_row, position: int) -> int:
        """One token from a (V,) logits row: argmax when greedy, else a
        draw from softmax(top-k-masked logits / T) with a generator
        seeded by (seed, rid, position)."""
        if req.greedy:
            return int(torch.argmax(logits_row))
        lf = logits_row.float()
        if req.top_k > 0:
            k = min(req.top_k, lf.shape[-1])
            thr = torch.topk(lf, k).values[-1]
            lf = torch.where(lf < thr, torch.full_like(lf, -float("inf")),
                             lf)
        probs = torch.softmax(lf / max(req.temperature, 1e-6), dim=-1)
        gen = torch.Generator(device=probs.device)
        gen.manual_seed(sample_seed(req.seed, req.rid, position))
        return int(torch.multinomial(probs, 1, generator=gen))

    # ------------------------------ admission ------------------------------

    def _admit(self) -> None:
        """FIFO admission while slots and pool allow (strict order)."""
        while self._queue and None in self._slots and self._job is None:
            req = self._queue[0]
            if req.arrival > self.step_count:
                break
            if not self._start(req):
                break
            self._queue.pop(0)

    def _prefill_chunks(self, prompt: np.ndarray, cap: int) -> list:
        """Split a prompt into (tokens, positions) chunks: attention-only
        families pad to the capacity bucket with position -1; families
        with a carried recurrence get exact-length chunks."""
        s = len(prompt)
        C = min(self.prefill_chunk or cap, cap)
        chunks = []
        if self.pad_prefill:
            toks = np.zeros(cap, np.int32)
            toks[:s] = prompt
            pos = np.where(np.arange(cap) < s, np.arange(cap), -1).astype(
                np.int32)
            for lo in range(0, cap, C):
                chunks.append((toks[None, lo:lo + C], pos[None, lo:lo + C]))
                if lo + C >= s:
                    break
        else:
            for lo in range(0, s, C):
                hi = min(lo + C, s)
                chunks.append((np.ascontiguousarray(prompt[None, lo:hi]),
                               np.arange(lo, hi, dtype=np.int32)[None]))
        return [(torch.from_numpy(t).to(self.device),
                 torch.from_numpy(p).to(self.device)) for t, p in chunks]

    def _start_job(self, req: Request) -> _PrefillJob | None:
        cache = self.cache
        s = len(req.prompt)
        n = cache.blocks_for(s)
        if cache.num_free < n:
            cache.reclaim(n)
        blocks = cache.alloc(n)
        if blocks is None:
            return None
        cap = _pow2_at_least(s, cache.block_size)
        if self.pad_prefill and self.prefill_chunk:
            # every chunk the same shape: round the bucket up to a chunk
            # multiple so no ragged tail appears
            C = min(self.prefill_chunk, cap)
            cap = -(-cap // C) * C
        state = self.model.init_seq_state(self.params, cap, batch_size=1,
                                          dtype=self.cfg.compute_dtype,
                                          device=self.device)
        return _PrefillJob(req, state, self._prefill_chunks(req.prompt, cap),
                           blocks)

    def _advance_job(self, job: _PrefillJob) -> None:
        toks, pos = job.chunks[job.next]
        self._prefill_shapes.add((tuple(toks.shape), job.state["k"].shape[2],
                                  job.next == 0))
        with span("engine.prefill_chunk", rid=job.req.rid,
                  chunk=job.next, width=toks.shape[1]):
            job.state, job.logits = self.model.forward(
                self.params, job.state, toks, pos, fresh=job.next == 0)
        job.next += 1

    def _finish_job(self, job: _PrefillJob) -> None:
        """Write the prefilled K/V into the reserved blocks and occupy a
        slot."""
        req, cache = job.req, self.cache
        s = len(req.prompt)
        cache.write_prompt(job.state["k"][:, 0, :s], job.state["v"][:, 0, :s],
                           job.blocks)
        extras1 = {k: job.state[k] for k in self._extras_keys}
        first = self._sample(req, job.logits[0], s)
        if self.share_prefixes and req.greedy:
            cache.register_prefix(req.prompt, job.blocks, s, first,
                                  extras=extras1 or None)
        self._occupy(req, job.blocks, s, first, extras1)

    def _occupy(self, req: Request, blocks, length: int, first: int,
                extras1: dict | None) -> None:
        req.blocks = blocks
        req.length = length
        req.tokens = [first]
        tnow = now()
        if req.t_first is None:    # TTFT: the first time it existed
            req.t_first = tnow
        req.t_last = tnow
        if req.done:               # max_new_tokens == 1
            if req.keep_blocks:
                # handoff: the blocks stay allocated (and the extras
                # stashed) until export_request() harvests them
                req.export_extras = extras1
            else:
                self.cache.free(blocks)
                req.blocks = []
            req.status = "done"
            self._record_request(req)
            self._done[req.rid] = req
            return
        req.slot = self._slots.index(None)
        if extras1:
            _scatter_slot(self._extras, extras1, req.slot)
        self._admission_seq += 1
        req.admitted_at = self._admission_seq
        req.status = "running"
        self._slots[req.slot] = req

    def _start(self, req: Request) -> bool:
        if req.t_admit is None:
            req.t_admit = now()
        if req.artifact is not None:
            return self._start_from_artifact(req)
        if self.share_prefixes and req.greedy:
            restored = self.cache.lookup_prefix(req.prompt)
            if restored is None and self.prefix_store is not None:
                # local miss -> the cluster store: a restore lands the
                # prefix in the local index, so the retry hits
                if self._restore_from_store(req.prompt):
                    restored = self.cache.lookup_prefix(req.prompt)
            if restored is not None:
                self._occupy(req, *restored)
                return True
        job = self._start_job(req)
        if job is None:
            return False
        if self.prefill_chunk and (self.prefill_role or
                                   any(r is not None for r in self._slots)):
            # chunked + a running batch: one chunk per step, interleaved
            # with the decode ticks
            req.status = "prefilling"
            self._job = job
            return True
        while not job.finished:
            self._advance_job(job)
        self._finish_job(job)
        return True

    # --------------------------- cluster handoff ---------------------------
    #
    # A request's whole serving state is its blocks (with the scale rows
    # of quantized pools), its length, its first sampled token (which the
    # blocks cannot reconstruct) and the extras; as host tensors it
    # imports into any engine of the same configuration.

    def export_request(self, rid: int) -> dict:
        """Harvest a finished ``keep_blocks`` request as a handoff
        artifact of host tensors and release its blocks."""
        req = self._done.pop(rid)
        art = {
            "prompt": req.prompt,
            "length": req.length,
            "first_token": int(req.tokens[0]),
            "blocks": self.cache.export_blocks(req.blocks),
            "extras": _host_tree(req.export_extras or {}),
            "t_submit": req.t_submit,
            "t_first": req.t_first,
            "n_evictions": req.n_evictions,
        }
        self.cache.free(req.blocks)
        req.blocks, req.export_extras = [], None
        return art

    def _import(self, length: int, blocks: dict, label: str, **attrs):
        """Allocate and fill the blocks of an imported prefill; None if
        the pool cannot hold them."""
        n = self.cache.blocks_for(length)
        if self.cache.num_free < n:
            self.cache.reclaim(n)
        ids = self.cache.alloc(n)
        if ids is None:
            return None
        with span(label, blocks=n, **attrs):
            self.cache.import_blocks(ids, blocks)
        return ids

    def _start_from_artifact(self, req: Request) -> bool:
        """Admit by importing an exported prefill.  TTFT stays anchored
        at the prefill replica's first token; an eviction after the
        import falls back to a local prefill, token-identical."""
        art = req.artifact
        length = int(art["length"])
        ids = self._import(length, art["blocks"], "engine.import_artifact",
                           rid=req.rid)
        if ids is None:
            return False
        extras = dict(art.get("extras") or {})
        first = int(art["first_token"])
        req.t_first = art.get("t_first")
        req.n_evictions += int(art.get("n_evictions") or 0)
        if self.share_prefixes and req.greedy:
            self.cache.register_prefix(req.prompt, ids, length, first,
                                       extras=extras or None)
        req.artifact = None     # imported; drop the host copy
        self._occupy(req, ids, length, first, extras)
        return True

    def _restore_from_store(self, prompt: np.ndarray) -> bool:
        """Pull a published prefix from the cluster store into the local
        index (alloc -> import -> register -> drop this ref: the index
        owns the blocks, as after a local prefill)."""
        art = self.prefix_store.fetch(_prefix_key(prompt))
        if art is None:
            return False
        length = int(art["length"])
        ids = self._import(length, art["blocks"], "engine.store_restore")
        if ids is None:
            return False
        extras = dict(art.get("extras") or {})
        self.cache.register_prefix(prompt, ids, length,
                                   int(art["first_token"]),
                                   extras=extras or None)
        self.cache.free(ids)    # the prefix index holds the live ref
        self._c_store_hits.inc()
        return True

    def _publish_prefix(self, key, ids, length, first, extras) -> None:
        """``on_prefix_evict`` hook: write a dropped prefix entry to the
        cluster store while its blocks are still readable (a host copy,
        complete before the blocks can be reused)."""
        with span("engine.store_publish", blocks=len(ids)):
            self.prefix_store.publish(key, {
                "length": int(length),
                "first_token": int(first),
                "blocks": self.cache.export_blocks(ids),
                "extras": _host_tree(extras) if extras else {},
            })

    # ------------------------------- decode --------------------------------

    def _bucket(self, n: int) -> int:
        return _pow2_at_least(n, max(self.min_table_width, 2))

    def _ensure_block(self, req: Request) -> bool:
        """Make sure the block table covers the next write position."""
        return self._ensure_blocks(req, req.length + 1)

    def _ensure_blocks(self, req: Request, n_tokens: int) -> bool:
        """Grow the block table to cover ``n_tokens`` cached positions
        (a speculative verify writes 1 + n_drafts at once)."""
        need = self.cache.blocks_for(n_tokens) - len(req.blocks)
        if need <= 0:
            return True
        if self.cache.num_free < need:
            self.cache.reclaim(need)
        got = self.cache.alloc(need)
        if got is None:
            return False
        req.blocks.extend(got)
        return True

    def _cancel_job(self) -> None:
        """Requeue the in-flight prefill job, releasing its blocks."""
        job, self._job = self._job, None
        req = job.req
        self.cache.free(job.blocks)
        req.status, req.arrival = "queued", self.step_count
        self._queue.insert(0, req)
        req.n_evictions += 1
        self._c_evictions.inc()

    def _evict_for_space(self, needy: Request) -> bool:
        """Pool exhausted mid-decode: preempt the youngest claimant (the
        in-flight prefill first, else the youngest running request,
        possibly ``needy``).  False iff ``needy`` is the sole claimant."""
        if self._job is not None:
            self._cancel_job()
            return True
        running = [r for r in self._slots if r is not None]
        if running == [needy]:
            return False
        self.evict(max(running, key=lambda r: r.admitted_at).rid)
        return True

    def evict(self, rid: int) -> None:
        """Free a running (or prefilling) request's blocks and restart it
        from the queue."""
        if self._job is not None and self._job.req.rid == rid:
            self._cancel_job()
            return
        for slot, req in enumerate(self._slots):
            if req is not None and req.rid == rid:
                self._slots[slot] = None
                if self.drafter is not None:
                    # replay re-prefills from scratch; drop the drafter's
                    # per-request state with it
                    self.drafter.release(rid)
                self.cache.free(req.blocks)
                req.blocks, req.tokens, req.length = [], [], 0
                req.slot, req.status = -1, "queued"
                req.arrival = self.step_count
                self._queue.insert(0, req)
                req.n_evictions += 1
                self._c_evictions.inc()
                return
        raise KeyError(f"request {rid} is not running")

    def _mark_arrivals(self) -> None:
        """Start the TTFT clock of the queued requests whose arrival step
        has come (the JAX engine starts it at submit())."""
        due = [r for r in self._queue
               if r.t_submit is None and r.arrival <= self.step_count]
        if due:
            tnow = now()
            for req in due:
                req.t_submit = tnow

    def step(self) -> int:
        """Advance the in-flight prefill one chunk, admit, decode one
        token for every running request, retire.  Returns tokens made."""
        self._mark_arrivals()
        if self._job is not None:
            self._advance_job(self._job)
            if self._job.finished:
                job, self._job = self._job, None
                self._finish_job(job)
        self._admit()
        active = [r for r in self._slots if r is not None]
        if not active:
            # done-but-unharvested keep_blocks requests hold blocks the
            # cluster has yet to export: an idle tick is progress
            held = any(r.blocks for r in self._done.values())
            if (self._job is None and self._queue and not held
                    and self._queue[0].arrival <= self.step_count):
                raise RuntimeError(
                    f"request {self._queue[0].rid} cannot be admitted even "
                    f"into an empty engine: prompt needs "
                    f"{self.cache.blocks_for(len(self._queue[0].prompt))} "
                    f"blocks, pool has {self.cache.num_free} free")
            self.step_count += 1
            return 0
        if self.drafter is not None:
            return self._spec_step()
        # walk slots, not a snapshot: _evict_for_space can clear any slot
        for slot in range(self.max_slots):
            req = self._slots[slot]
            if req is None:
                continue
            while self._slots[slot] is req and not self._ensure_block(req):
                if not self._evict_for_space(req):
                    raise RuntimeError(
                        f"KV pool exhausted: request {req.rid} needs a "
                        f"block and nothing is evictable")
        active = [r for r in self._slots if r is not None]

        width = self._bucket(max(len(r.blocks) for r in active))
        tables = np.zeros((self.max_slots, width), np.int32)
        lengths = np.zeros(self.max_slots, np.int32)
        tokens = np.zeros(self.max_slots, np.int32)
        for r in active:
            tables[r.slot, :len(r.blocks)] = r.blocks
            lengths[r.slot] = r.length
            tokens[r.slot] = r.tokens[-1]
        dev = self.device
        state = self._paged_state(tables, lengths, self._extras)
        self._decode_shapes.add(width)
        with span("engine.decode_tick", step=self.step_count,
                  active=len(active)):
            # the pools are updated in place (the JAX engine donates them)
            state, logits = self.model.forward(
                self.params, state, torch.from_numpy(tokens).to(dev)[:, None],
                state["lengths"][:, None])
        self._extras = {k: state[k] for k in self._extras_keys}
        if all(r.greedy for r in active):
            # one (max_slots,) transfer, not (max_slots, vocab)
            next_toks = torch.argmax(logits, dim=-1).cpu().numpy()
        else:
            next_toks = np.asarray(
                [self._sample(r, logits[r.slot], r.length + 1)
                 if r is not None else 0 for r in self._slots])

        produced = 0
        tnow = now()
        for r in active:
            r.length += 1
            r.tokens.append(int(next_toks[r.slot]))
            produced += 1
            if r.t_last is not None:
                dt = tnow - r.t_last
                self._h_tpot.record(dt)
                r.tpot_sum += dt
                r.tpot_n += 1
            r.t_last = tnow
            if r.done:
                self._slots[r.slot] = None
                self.cache.free(r.blocks)
                r.slot, r.status = -1, "done"
                self._record_request(r)
                self._done[r.rid] = r
        self.step_count += 1
        return produced

    def _paged_state(self, tables: np.ndarray, lengths: np.ndarray,
                     extras: dict) -> dict:
        """The paged SeqState of a tick: the pools (and scale rows),
        block tables, per-slot lengths and the extras pools."""
        dev = self.device
        state = {"k": self.cache.k, "v": self.cache.v,
                 "block_tables": torch.from_numpy(tables).to(dev),
                 "lengths": torch.from_numpy(lengths).to(dev), **extras}
        if self.cache.quantized:
            state["k_scale"] = self.cache.k_scale
            state["v_scale"] = self.cache.v_scale
        return state

    # ---------------------------- speculation ------------------------------

    def _spec_step(self) -> int:
        """One speculative decode tick.

        Draft: up to ``draft_k`` tokens a slot from its own history.
        Verify: one (max_slots, draft_k + 1) chunk through the paged
        kernel, row 0 the slot's last emitted token at its write
        position, rows 1..n its drafts, the rest padding (position -1:
        no KV write, zero attention rows); an empty proposal is a plain
        decode tick inside the same chunk.  Accept: the longest matching
        prefix per slot (greedy: exact argmax match; sampled: the
        rejection rule) plus a bonus token from the stop row.  Rollback:
        block references past the accepted region are dropped and, for
        the hybrid, the mamba extras are re-advanced from the pre-verify
        snapshot through the accepted rows only."""
        k = self.draft_k
        T = k + 1
        cache = self.cache
        # propose + reserve blocks (walk slots, not a snapshot:
        # _evict_for_space can clear any slot mid-loop)
        proposals: dict[int, list] = {}
        for slot in range(self.max_slots):
            req = self._slots[slot]
            if req is None:
                continue
            cap = min(k, req.max_new_tokens - len(req.tokens) - 1)
            prop: list = []
            if cap > 0:
                hist = np.concatenate(
                    [req.prompt, np.asarray(req.tokens, np.int32)])
                prop = [int(t) for t in
                        self.drafter.propose(req.rid, hist, cap)][:cap]
            # the verify writes positions length..length+n; under pool
            # pressure shrink the proposal to a plain tick before evicting
            while self._slots[slot] is req and not self._ensure_blocks(
                    req, req.length + 1 + len(prop)):
                if prop:
                    prop = []
                    continue
                if not self._evict_for_space(req):
                    raise RuntimeError(
                        f"KV pool exhausted: request {req.rid} needs a "
                        f"block and nothing is evictable")
            if self._slots[slot] is req:
                proposals[req.rid] = prop
        active = [r for r in self._slots if r is not None]
        if not active:
            self.step_count += 1
            return 0

        width = self._bucket(max(len(r.blocks) for r in active))
        tables = np.zeros((self.max_slots, width), np.int32)
        lengths = np.zeros(self.max_slots, np.int32)
        toks = np.zeros((self.max_slots, T), np.int32)
        pos = np.full((self.max_slots, T), -1, np.int32)
        dnext = np.zeros((self.max_slots, T), np.int32)
        for r in active:
            prop = proposals.get(r.rid) or []
            n = len(prop)
            tables[r.slot, :len(r.blocks)] = r.blocks
            lengths[r.slot] = r.length
            toks[r.slot, 0] = r.tokens[-1]
            toks[r.slot, 1:n + 1] = prop
            pos[r.slot, :n + 1] = np.arange(r.length, r.length + n + 1)
            dnext[r.slot, :n] = prop
        dev = self.device
        # the recurrent-state rollback anchor: the forward builds new
        # extras tensors and nothing writes these before the fix-up
        snap_extras = dict(self._extras) if self._extras_keys else None
        state = self._paged_state(tables, lengths, self._extras)
        ttoks = torch.from_numpy(toks).to(dev)
        self._decode_shapes.add((width, T))
        with span("engine.spec_tick", step=self.step_count,
                  active=len(active), draft_k=k):
            state, logits = self.model.forward(
                self.params, state, ttoks, torch.from_numpy(pos).to(dev),
                all_logits=True)
        self._extras = {kk: state[kk] for kk in self._extras_keys}

        # acceptance, combined per slot on the host
        if all(r.greedy for r in active):
            gn = torch.argmax(logits, dim=-1).cpu().numpy()
            acc = rej = plain = None
        else:
            seeds = [None] * self.max_slots
            for r in active:
                if not r.greedy:
                    seeds[r.slot] = (lambda p, r=r:
                                     sample_seed(r.seed, r.rid, p))
            temps = [r.temperature if r is not None else 0.0
                     for r in self._slots]
            topks = [r.top_k if r is not None else 0 for r in self._slots]
            gn, acc, rej, plain = spec_accept(logits, dnext, seeds, pos,
                                              temps, topks)
        emitted: dict[int, list] = {}
        for r in active:
            emitted[r.rid] = longest_accept(
                r.greedy, proposals.get(r.rid) or [], gn[r.slot],
                None if acc is None else acc[r.slot],
                None if rej is None else rej[r.slot],
                None if plain is None else plain[r.slot])

        if snap_extras is not None and any(
                len(emitted[r.rid]) - 1 < len(proposals.get(r.rid) or [])
                for r in active):
            self._spec_fixup(active, emitted, tables, lengths, ttoks,
                             snap_extras)

        # emit + rollback + retire
        produced = 0
        tnow = now()
        for r in active:
            out = emitted[r.rid]
            n = len(proposals.get(r.rid) or [])
            m = len(out) - 1                   # accepted drafts
            self._h_spec_tps.record(len(out))
            if n:
                self._h_spec_acc.record(m / n)
            # keep the references covering positions 0..length+m; the
            # rejected tail's drop
            r.blocks = cache.rollback(r.blocks, r.length + m + 1)
            r.length += m + 1
            r.tokens.extend(out)
            produced += len(out)
            if r.t_last is not None:
                # one sweep made len(out) tokens: TPOT stays "time per
                # emitted token"
                dt = (tnow - r.t_last) / len(out)
                for _ in range(len(out)):
                    self._h_tpot.record(dt)
                r.tpot_sum += dt * len(out)
                r.tpot_n += len(out)
            r.t_last = tnow
            if r.done:
                self._slots[r.slot] = None
                self.drafter.release(r.rid)
                cache.free(r.blocks)
                r.blocks = []
                r.slot, r.status = -1, "done"
                self._record_request(r)
                self._done[r.rid] = r
        self.step_count += 1
        return produced

    def _spec_fixup(self, active, emitted, tables, lengths, ttoks,
                    snap_extras) -> None:
        """The hybrid correction pass: a partially accepted slot advanced
        its mamba recurrence through rejected rows, so the verify chunk
        re-runs from the pre-verify snapshot with those rows padded out.
        KV rewrites at the accepted positions are bit-identical (same
        ops, per-row position masking); only the extras change."""
        pos2 = np.full(ttoks.shape, -1, np.int32)
        for r in active:
            mm = len(emitted[r.rid])           # accepted rows = m + 1
            pos2[r.slot, :mm] = np.arange(r.length, r.length + mm)
        state = self._paged_state(tables, lengths, snap_extras)
        with span("engine.spec_fixup", step=self.step_count):
            state, _ = self.model.forward(
                self.params, state, ttoks,
                torch.from_numpy(pos2).to(self.device), all_logits=True)
        self._extras = {kk: state[kk] for kk in self._extras_keys}

    # -------------------------------- drive --------------------------------

    def run(self, max_steps: int = 100_000) -> dict[int, np.ndarray]:
        """Step until queue and slots drain; {rid: (max_new_tokens,)}."""
        for _ in range(max_steps):
            if (not self._queue and self._job is None
                    and all(s is None for s in self._slots)):
                break
            self.step()
        else:
            raise RuntimeError("serving trace did not drain")
        out = {rid: np.asarray(req.tokens[:req.max_new_tokens], np.int32)
               for rid, req in self._done.items()}
        self._done.clear()
        return out

    # ------------------------------ telemetry ------------------------------

    def _record_request(self, req: Request) -> None:
        self._c_completed.inc()
        ttft = queue_wait = None
        if req.t_submit is not None and req.t_first is not None:
            ttft = req.t_first - req.t_submit
            self._h_ttft.record(ttft)
        if req.t_submit is not None and req.t_admit is not None:
            queue_wait = req.t_admit - req.t_submit
            self._h_queue.record(queue_wait)
        if len(self._request_log) < self._request_log_cap:
            self._request_log.append({
                "rid": req.rid, "prompt_len": len(req.prompt),
                "n_tokens": len(req.tokens), "ttft_s": ttft,
                "queue_wait_s": queue_wait,
                "tpot_mean_s": (req.tpot_sum / req.tpot_n
                                if req.tpot_n else None),
                "evictions": req.n_evictions,
            })

    def request_metrics(self) -> dict:
        """TTFT (arrival -> first token), per-token TPOT and queue wait
        (arrival -> admission) over every completed request, in
        seconds."""
        def dist(h):
            return {"count": h.count, "mean_s": h.mean,
                    "p50_s": h.percentile(50), "p95_s": h.percentile(95),
                    "p99_s": h.percentile(99)}
        return {
            "completed": self._c_completed.value,
            "evictions": self._c_evictions.value,
            "ttft": dist(self._h_ttft),
            "tpot": dist(self._h_tpot),
            "queue_wait": dist(self._h_queue),
            "requests": list(self._request_log),
        }

    @property
    def stats(self) -> dict:
        """The unified serving stats schema (``serving/stats.py``) plus
        the engine's extras."""
        speculating = self.drafter is not None
        extra = {}
        if speculating:
            extra["spec_accept_rate"] = (self._h_spec_acc.mean
                                         if self._h_spec_acc.count else 0.0)
        return serving_stats(
            requests_completed=self._c_completed.value,
            queue_depth=len(self._queue) + (1 if self._job is not None
                                            else 0),
            evictions=self.evictions,
            ttft=self._h_ttft, tpot=self._h_tpot,
            tokens_per_step=(self._h_spec_tps.mean
                             if speculating and self._h_spec_tps.count
                             else 1.0),
            **extra,
            steps=self.step_count,
            active_slots=sum(r is not None for r in self._slots),
            prefix_hit_rate=self.cache.hit_rate,
            store_hits=self._c_store_hits.value,
            free_blocks=self.cache.num_free,
            prefill_traces=self.prefill_traces,
            decode_traces=self.decode_traces,
        )
