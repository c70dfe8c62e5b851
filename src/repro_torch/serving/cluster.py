"""Disaggregated serving: M prefill + N decode replicas behind one door
(port of ``repro/serving/cluster.py``).

Prompt processing is compute-bound and batches badly with decode's
latency-bound one-token ticks, so each phase gets its own replica pool
sized to its own SLO.  ``ServingCluster`` wires:

* **admission**: ``platform.SLORouter`` scores every prefill replica's
  unified stats (queue depth, active slots, TTFT p95 against the
  target) and admits to the cheapest;
* **prefill leg**: the replica runs the prompt to its first token with
  ``keep_blocks=True``; its blocks (scale rows, extras) stay allocated
  until the cluster harvests them;
* **handoff**: ``engine.export_request`` copies the request's state to
  host tensors; the router picks the decode replica with the lowest
  TPOT pressure and ``engine.submit_prefilled`` imports the blocks
  there, so the decode replica never runs the prompt;
* **cluster prefix cache**: the prefill replicas share one
  ``FS3PrefixStore``: locally dropped prefix entries are published and
  a cold prefill first tries the store.

Greedy decode depends only on (params, prompt), so the cluster's token
streams equal a monolithic ``ServingEngine``'s.  The replicas share one
params tree; each holds its own KV pool.  The TTFT clock of a request
starts at the cluster step at which it arrives (as the port's engine
does).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.platform.scheduler import ServingSLO, SLORouter
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.stats import serving_stats
from repro_torch.telemetry import Histogram, Registry, now, span


@dataclasses.dataclass
class ClusterRequest:
    prompt: np.ndarray
    max_new_tokens: int
    arrival: int = 0                  # earliest admissible cluster step
    crid: int = -1
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    t_submit: float | None = None
    # -- routing / lifecycle (cluster-owned) --
    phase: str = "queued"             # queued | prefill | decode | done
    prefill_replica: int = -1
    decode_replica: int = -1
    first_token: int | None = None
    tokens: np.ndarray | None = None
    ttft_s: float | None = None
    tpot_mean_s: float | None = None
    evictions: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


class ServingCluster:
    """M prefill + N decode ``ServingEngine`` replicas, one submit()."""

    def __init__(self, model, params, *, prefill_replicas: int = 2,
                 decode_replicas: int = 2, slo_ttft_ms: float = 1000.0,
                 slo_tpot_ms: float = 200.0, prefix_store=None,
                 engine_kwargs: dict | None = None,
                 prefill_engine_kwargs: dict | None = None,
                 decode_engine_kwargs: dict | None = None,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 device=None):
        if prefill_replicas < 1 or decode_replicas < 1:
            raise ValueError("need at least one replica per role")
        self.model = model
        self.params = params
        self.device = resolve_device(device)
        self.slo = ServingSLO(ttft_ms=slo_ttft_ms, tpot_ms=slo_tpot_ms)
        self.router = SLORouter(self.slo)
        self.prefix_store = prefix_store
        self.temperature = temperature
        self.top_k = top_k
        self.seed = seed
        base = dict(engine_kwargs or {})
        pf_kw = {**base, **(prefill_engine_kwargs or {})}
        dc_kw = {**base, **(decode_engine_kwargs or {})}
        # prefill replicas publish / fetch through the shared store;
        # decode replicas stay off it (their blocks arrive by handoff)
        self.prefill_engines = [
            ServingEngine(model, params, prefill_role=True,
                          prefix_store=prefix_store, device=self.device,
                          **pf_kw)
            for _ in range(prefill_replicas)]
        self.decode_engines = [
            ServingEngine(model, params, device=self.device, **dc_kw)
            for _ in range(decode_replicas)]

        self.metrics = Registry("cluster")
        self._c_completed = self.metrics.counter("cluster.requests_completed")
        self._h_ttft = self.metrics.histogram("cluster.ttft_s")

        self._queue: list[ClusterRequest] = []
        self._by_crid: dict[int, ClusterRequest] = {}
        self._pf_inflight: dict[tuple, ClusterRequest] = {}  # (i, rid)
        self._dc_inflight: dict[tuple, ClusterRequest] = {}  # (j, rid)
        self._done: dict[int, ClusterRequest] = {}
        self._next_crid = 0
        self.step_count = 0
        self._request_log: list[dict] = []
        self._request_log_cap = 10_000

    # ------------------------------- intake --------------------------------

    def submit(self, prompt, max_new_tokens: int, arrival: int = 0,
               temperature: float | None = None, top_k: int | None = None,
               seed: int | None = None) -> int:
        creq = ClusterRequest(
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=max_new_tokens, arrival=arrival,
            temperature=self.temperature if temperature is None
            else temperature,
            top_k=self.top_k if top_k is None else top_k,
            seed=self.seed if seed is None else seed,
            crid=self._next_crid)
        self._next_crid += 1
        self._queue.append(creq)
        self._by_crid[creq.crid] = creq
        return creq.crid

    # ------------------------------- routing -------------------------------

    def _admit(self) -> None:
        """Route every due queued request to a prefill replica (FIFO in
        arrival order; SLO-scored across replicas)."""
        remaining = []
        for creq in self._queue:
            if creq.arrival > self.step_count:
                remaining.append(creq)
                continue
            if creq.t_submit is None:     # the TTFT clock starts here
                creq.t_submit = now()
            stats = [e.stats for e in self.prefill_engines]
            i = self.router.pick_prefill(stats)
            with span("router.route_prefill", crid=creq.crid, replica=i):
                rid = self.prefill_engines[i].submit(
                    creq.prompt, 1, keep_blocks=True,
                    t_submit=creq.t_submit, temperature=creq.temperature,
                    top_k=creq.top_k, seed=creq.seed)
            creq.phase, creq.prefill_replica = "prefill", i
            self._pf_inflight[(i, rid)] = creq
        self._queue = remaining

    def _harvest_prefill(self) -> None:
        """Export finished prefills and hand each to a decode replica."""
        for i, eng in enumerate(self.prefill_engines):
            for rid in list(eng._done):
                creq = self._pf_inflight.pop((i, rid), None)
                if creq is None:
                    continue
                art = eng.export_request(rid)
                if art["t_first"] is not None and creq.t_submit is not None:
                    creq.ttft_s = art["t_first"] - creq.t_submit
                    self._h_ttft.record(creq.ttft_s)
                creq.first_token = int(art["first_token"])
                creq.evictions += int(art["n_evictions"])
                if creq.max_new_tokens == 1:
                    self._finalize(creq, [creq.first_token], None)
                    continue
                stats = [e.stats for e in self.decode_engines]
                j = self.router.pick_decode(stats)
                with span("router.route_decode", crid=creq.crid, replica=j):
                    drid = self.decode_engines[j].submit_prefilled(
                        art, creq.max_new_tokens,
                        temperature=creq.temperature, top_k=creq.top_k,
                        seed=creq.seed)
                creq.phase, creq.decode_replica = "decode", j
                self._dc_inflight[(j, drid)] = creq

    def _harvest_decode(self) -> None:
        for j, eng in enumerate(self.decode_engines):
            for rid in list(eng._done):
                creq = self._dc_inflight.pop((j, rid), None)
                if creq is None:
                    continue
                req = eng._done.pop(rid)
                creq.evictions = req.n_evictions
                tpot = (req.tpot_sum / req.tpot_n) if req.tpot_n else None
                self._finalize(creq, req.tokens[:req.max_new_tokens], tpot)

    def _finalize(self, creq: ClusterRequest, tokens, tpot_mean) -> None:
        creq.tokens = np.asarray(tokens, np.int32)
        creq.tpot_mean_s = tpot_mean
        creq.phase = "done"
        self._done[creq.crid] = creq
        self._c_completed.inc()
        if len(self._request_log) < self._request_log_cap:
            self._request_log.append({
                "crid": creq.crid, "prompt_len": len(creq.prompt),
                "n_tokens": len(creq.tokens), "ttft_s": creq.ttft_s,
                "tpot_mean_s": creq.tpot_mean_s,
                "evictions": creq.evictions,
                "prefill_replica": creq.prefill_replica,
                "decode_replica": creq.decode_replica,
            })

    # -------------------------------- drive --------------------------------

    def step(self) -> None:
        """One cluster tick: admit, advance every replica one engine
        step, harvest finished prefills into decode legs, harvest
        finished decodes."""
        self._admit()
        for eng in self.prefill_engines:
            eng.step()
        self._harvest_prefill()
        for eng in self.decode_engines:
            eng.step()
        self._harvest_decode()
        self.step_count += 1

    def run(self, max_steps: int = 100_000) -> dict[int, np.ndarray]:
        """Step until everything drains; {crid: (max_new_tokens,)}."""
        for _ in range(max_steps):
            if (not self._queue and not self._pf_inflight
                    and not self._dc_inflight):
                break
            self.step()
        else:
            raise RuntimeError("cluster trace did not drain")
        out = {crid: creq.tokens for crid, creq in self._done.items()}
        for creq in self._done.values():
            self._by_crid.pop(creq.crid, None)
        self._done.clear()      # long-lived server: don't retain history
        return out

    def evict(self, crid: int) -> None:
        """Preempt a cluster request wherever it runs (decode replays
        deterministically from the replica's local prefix or a cold
        prefill)."""
        creq = self._by_crid.get(crid)
        if creq is None:
            raise KeyError(f"cluster request {crid} unknown")
        for (j, rid), c in self._dc_inflight.items():
            if c is creq:
                self.decode_engines[j].evict(rid)
                return
        for (i, rid), c in self._pf_inflight.items():
            if c is creq:
                self.prefill_engines[i].evict(rid)
                return
        raise KeyError(f"cluster request {crid} is not running")

    def flush_prefixes(self) -> int:
        """Drop every replica-local prefix entry (the prefill replicas
        publish theirs to the store first): local warmth becomes
        cluster-wide warmth."""
        return sum(e.cache.drop_prefixes()
                   for e in self.prefill_engines + self.decode_engines)

    # ------------------------------ telemetry ------------------------------

    def _merged(self, name: str, hists) -> Histogram:
        h = Histogram(name)
        for src in hists:
            h.merge(src)
        return h

    def stats(self) -> dict:
        """The unified serving stats schema with the per-replica stats
        nested under ``replicas``."""
        replicas = {f"prefill{i}": e.stats
                    for i, e in enumerate(self.prefill_engines)}
        replicas.update({f"decode{j}": e.stats
                         for j, e in enumerate(self.decode_engines)})
        extra = {}
        if self.prefix_store is not None:
            extra.update(store_publishes=self.prefix_store.publishes,
                         store_hits=sum(e._c_store_hits.value
                                        for e in self.prefill_engines))
        # tokens per step and acceptance over the decode leg only
        # (prefill replicas never decode)
        spec_tps = self._merged(
            "cluster.spec_tokens_per_step",
            (e._h_spec_tps for e in self.decode_engines))
        if any(e.drafter is not None for e in self.decode_engines):
            spec_acc = self._merged(
                "cluster.spec_accept_rate",
                (e._h_spec_acc for e in self.decode_engines))
            extra["spec_accept_rate"] = (spec_acc.mean
                                         if spec_acc.count else 0.0)
        return serving_stats(
            requests_completed=self._c_completed.value,
            queue_depth=len(self._queue) + sum(
                r["queue_depth"] for r in replicas.values()),
            evictions=sum(r["evictions"] for r in replicas.values()),
            ttft=self._h_ttft,
            tpot=self._merged("cluster.tpot_s",
                              (e._h_tpot for e in self.decode_engines)),
            tokens_per_step=spec_tps.mean if spec_tps.count else 1.0,
            replicas=replicas,
            steps=self.step_count,
            inflight=len(self._pf_inflight) + len(self._dc_inflight),
            **extra,
        )

    def request_metrics(self) -> dict:
        """The cluster's mirror of ``ServingEngine.request_metrics``:
        TTFT end to end (arrival at the cluster -> the prefill replica's
        first token); TPOT and queue wait merge the replicas'
        histograms."""
        def dist(h):
            return {"count": h.count, "mean_s": h.mean,
                    "p50_s": h.percentile(50), "p95_s": h.percentile(95),
                    "p99_s": h.percentile(99)}
        tpot = self._merged("cluster.tpot_s",
                            (e._h_tpot for e in self.decode_engines))
        queue = self._merged("cluster.queue_wait_s",
                             (e._h_queue for e in self.prefill_engines))
        return {
            "completed": self._c_completed.value,
            "evictions": sum(e.evictions for e in
                             self.prefill_engines + self.decode_engines),
            "ttft": dist(self._h_ttft),
            "tpot": dist(tpot),
            "queue_wait": dist(queue),
            "requests": list(self._request_log),
        }
