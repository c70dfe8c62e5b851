"""Continuous-batching engine over the paged KV cache (port of
``repro/serving/engine.py`` without speculation, the cluster prefix
store or the prefill/decode handoff).

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
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.serving.paged_cache import PagedKVCache
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
                 kv_dtype: str | None = None, device=None):
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

        self.metrics = Registry("engine")
        self._c_evictions = self.metrics.counter("engine.evictions")
        self._c_completed = self.metrics.counter("engine.requests_completed")
        self._h_ttft = self.metrics.histogram("engine.ttft_s")
        self._h_tpot = self.metrics.histogram("engine.tpot_s")
        self._h_queue = self.metrics.histogram("engine.queue_wait_s")
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
               seed: int | None = None) -> int:
        req = Request(prompt=np.asarray(prompt, np.int32).reshape(-1),
                      max_new_tokens=max_new_tokens, arrival=arrival,
                      temperature=self.temperature if temperature is None
                      else temperature,
                      top_k=self.top_k if top_k is None else top_k,
                      seed=self.seed if seed is None else seed,
                      rid=self._next_rid,
                      t_submit=now() if arrival <= self.step_count else None)
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
        if self.share_prefixes and req.greedy:
            restored = self.cache.lookup_prefix(req.prompt)
            if restored is not None:
                self._occupy(req, *restored)
                return True
        job = self._start_job(req)
        if job is None:
            return False
        if self.prefill_chunk and any(r is not None for r in self._slots):
            # chunked + a running batch: one chunk per step, interleaved
            # with the decode ticks
            req.status = "prefilling"
            self._job = job
            return True
        while not job.finished:
            self._advance_job(job)
        self._finish_job(job)
        return True

    # ------------------------------- decode --------------------------------

    def _bucket(self, n: int) -> int:
        return _pow2_at_least(n, max(self.min_table_width, 2))

    def _ensure_block(self, req: Request) -> bool:
        """Make sure the block table covers the next write position."""
        need = self.cache.blocks_for(req.length + 1) - len(req.blocks)
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
            if (self._job is None and self._queue
                    and self._queue[0].arrival <= self.step_count):
                raise RuntimeError(
                    f"request {self._queue[0].rid} cannot be admitted even "
                    f"into an empty engine: prompt needs "
                    f"{self.cache.blocks_for(len(self._queue[0].prompt))} "
                    f"blocks, pool has {self.cache.num_free} free")
            self.step_count += 1
            return 0
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
        jlen = torch.from_numpy(lengths).to(dev)
        state = {"k": self.cache.k, "v": self.cache.v,
                 "block_tables": torch.from_numpy(tables).to(dev),
                 "lengths": jlen, **self._extras}
        if self.cache.quantized:
            state["k_scale"] = self.cache.k_scale
            state["v_scale"] = self.cache.v_scale
        self._decode_shapes.add(width)
        with span("engine.decode_tick", step=self.step_count,
                  active=len(active)):
            # the pools are updated in place (the JAX engine donates them)
            state, logits = self.model.forward(
                self.params, state, torch.from_numpy(tokens).to(dev)[:, None],
                jlen[:, None])
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
        return serving_stats(
            requests_completed=self._c_completed.value,
            queue_depth=len(self._queue) + (1 if self._job is not None
                                            else 0),
            evictions=self.evictions,
            ttft=self._h_ttft, tpot=self._h_tpot,
            steps=self.step_count,
            active_slots=sum(r is not None for r in self._slots),
            prefix_hit_rate=self.cache.hit_rate,
            free_blocks=self.cache.num_free,
            prefill_traces=self.prefill_traces,
            decode_traces=self.decode_traces,
        )
