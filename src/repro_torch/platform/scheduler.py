"""HAI-platform time-sharing scheduler (paper §VI-C, §III-B).

Semantics reproduced:
  * cluster nodes are classified (zone, type), NOT pooled;
  * tasks are gang-scheduled whole-node allocations; higher-priority tasks
    interrupt lower ones (interrupt -> task checkpoints -> requeue);
  * **cross-zone rule**: at most ONE running task may span both fat-tree
    zones (the paper's guarantee that only one pair of nodes communicates
    across the inter-zone links);
  * failed nodes (validator / failure model) leave the schedulable pool;
  * utilization accounting (the paper reports 99 % with time-sharing).

A copy of ``repro/platform/scheduler.py`` (pure Python).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Optional


@dataclasses.dataclass
class Task:
    task_id: int
    n_nodes: int
    priority: int              # higher preempts lower
    runtime_hours: float
    remaining_hours: float = -1.0
    zone_pref: Optional[int] = None
    # bookkeeping
    nodes: tuple = ()
    state: str = "queued"      # queued | running | done | interrupted
    interruptions: int = 0
    cross_zone: bool = False

    def __post_init__(self):
        if self.remaining_hours < 0:
            self.remaining_hours = self.runtime_hours


class Cluster:
    def __init__(self, n_nodes: int = 16, zones: int = 2):
        self.zones = zones
        self.nodes = {i: {"zone": i % zones, "healthy": True, "task": None}
                      for i in range(n_nodes)}

    def free_nodes(self, zone: Optional[int] = None) -> list[int]:
        return [i for i, n in self.nodes.items()
                if n["healthy"] and n["task"] is None
                and (zone is None or n["zone"] == zone)]

    def mark_failed(self, node: int):
        self.nodes[node]["healthy"] = False

    def repair(self, node: int):
        self.nodes[node]["healthy"] = True


class Scheduler:
    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        self._queue: list = []     # (-priority, seq, Task)
        self._seq = itertools.count()
        self.running: dict[int, Task] = {}
        self.done: list[Task] = []
        self.time = 0.0
        self._busy_node_hours = 0.0
        self._cap_node_hours = 0.0

    # ------------- queue ops -------------

    def submit(self, task: Task):
        task.state = "queued"
        heapq.heappush(self._queue, (-task.priority, next(self._seq), task))

    def _cross_zone_running(self) -> bool:
        return any(t.cross_zone for t in self.running.values())

    def _try_place(self, task: Task) -> bool:
        # try single-zone placement first (cheapest for the fabric)
        for z in range(self.cluster.zones):
            free = self.cluster.free_nodes(z)
            if task.zone_pref is not None and z != task.zone_pref:
                continue
            if len(free) >= task.n_nodes:
                self._start(task, free[: task.n_nodes], cross=False)
                return True
        # cross-zone: allowed only if no other cross-zone task runs
        free = self.cluster.free_nodes()
        if len(free) >= task.n_nodes and not self._cross_zone_running() \
                and task.zone_pref is None:
            self._start(task, free[: task.n_nodes], cross=True)
            return True
        return False

    def _start(self, task: Task, nodes: list[int], cross: bool):
        task.nodes = tuple(nodes)
        task.state = "running"
        task.cross_zone = cross
        for n in nodes:
            self.cluster.nodes[n]["task"] = task.task_id
        self.running[task.task_id] = task

    def _stop(self, task: Task, state: str):
        for n in task.nodes:
            if self.cluster.nodes[n]["task"] == task.task_id:
                self.cluster.nodes[n]["task"] = None
        task.nodes = ()
        task.state = state
        self.running.pop(task.task_id, None)

    def interrupt(self, task_id: int):
        """Platform signal: checkpoint + requeue (paper's task lifecycle)."""
        task = self.running.get(task_id)
        if task is None:
            return
        task.interruptions += 1
        self._stop(task, "interrupted")
        self.submit(task)

    def _maybe_preempt_for(self, task: Task):
        """Interrupt enough lowest-priority tasks to fit `task`."""
        victims = sorted(self.running.values(), key=lambda t: t.priority)
        freed = len(self.cluster.free_nodes())
        for v in victims:
            if freed >= task.n_nodes:
                break
            if v.priority < task.priority:
                freed += v.n_nodes
                self.interrupt(v.task_id)

    def schedule(self):
        """Place as many queued tasks as possible (priority order)."""
        requeue = []
        while self._queue:
            _, _, task = heapq.heappop(self._queue)
            if task.state == "done":
                continue
            if not self._try_place(task):
                self._maybe_preempt_for(task)
                if not self._try_place(task):
                    requeue.append(task)
                    # strict priority: don't let lower-priority jump ahead
                    break
        for t in requeue:
            heapq.heappush(self._queue, (-t.priority, next(self._seq), t))
        while self._queue and self._queue[0][2].state == "done":
            heapq.heappop(self._queue)

    # ------------- time & failures -------------

    def advance(self, hours: float):
        """Run `hours` of cluster time."""
        self.schedule()
        healthy = sum(n["healthy"] for n in self.cluster.nodes.values())
        self._cap_node_hours += healthy * hours
        for task in list(self.running.values()):
            task.remaining_hours -= hours
            self._busy_node_hours += task.n_nodes * hours
            if task.remaining_hours <= 1e-9:
                self._stop(task, "done")
                self.done.append(task)
        self.time += hours
        self.schedule()

    def node_failure(self, node: int):
        """Failure-model hook: fail node, interrupt the task on it."""
        tid = self.cluster.nodes[node]["task"]
        self.cluster.mark_failed(node)
        if tid is not None:
            self.interrupt(tid)

    def utilization(self) -> float:
        return self._busy_node_hours / max(self._cap_node_hours, 1e-9)


# --------------------------- serving router ----------------------------
#
# The serving-side counterpart of the gang scheduler above: instead of
# whole-node allocations, it places *requests* onto serving replicas.
# Placement is SLO-aware, not FIFO — each replica is scored against the
# deployment's TTFT/TPOT targets using its live unified stats dict
# (serving/stats.py schema: queue_depth, active_slots, ttft_p95/tpot_p95),
# so a replica whose tail latency is already past target stops winning
# admissions until it recovers.


@dataclasses.dataclass(frozen=True)
class ServingSLO:
    """Latency targets for one deployment (milliseconds)."""
    ttft_ms: float = 1000.0
    tpot_ms: float = 200.0

    @property
    def ttft_s(self) -> float:
        return self.ttft_ms / 1e3

    @property
    def tpot_s(self) -> float:
        return self.tpot_ms / 1e3


def slo_score(queue_depth: int, inflight: int, p95_s: float,
              slo_s: float) -> float:
    """Load x SLO-pressure score; lower wins.

    Load is the replica's total commitment (queued + in-flight, +1 so an
    idle replica scores its pressure, not zero); pressure is how far its
    p95 sits past the target, floored at 1 so replicas inside SLO
    compete on load alone.  No recorded latency yet (p95 == 0) also
    means pressure 1: an untouched replica is assumed healthy."""
    pressure = 1.0
    if p95_s > 0 and slo_s > 0:
        pressure = max(1.0, p95_s / slo_s)
    return (1.0 + queue_depth + inflight) * pressure


class SLORouter:
    """Pick the replica whose admission least endangers the SLO.

    Prefill placement scores against the TTFT target (queue depth is
    what delays a first token); decode placement against the TPOT
    target (active slots are what dilate the per-token interval).  Ties
    rotate round-robin per role, so an idle cluster still spreads
    identical requests across replicas instead of piling onto index 0.
    """

    def __init__(self, slo: ServingSLO | None = None):
        self.slo = slo or ServingSLO()
        self._rr = {"prefill": 0, "decode": 0}

    def _pick(self, role: str, scores: list[float]) -> int:
        n = len(scores)
        if n == 0:
            raise ValueError(f"no {role} replicas to route to")
        best = min(scores)
        start = self._rr[role]
        idx = next(i for i in (((start + j) % n) for j in range(n))
                   if scores[i] == best)
        self._rr[role] = (idx + 1) % n
        return idx

    def pick_prefill(self, stats_list: list[dict]) -> int:
        """Index of the prefill replica to admit into; ``stats_list``
        holds each replica's unified stats dict."""
        return self._pick("prefill", [
            slo_score(s["queue_depth"], s.get("active_slots", 0),
                      s["ttft_p95"], self.slo.ttft_s)
            for s in stats_list])

    def pick_decode(self, stats_list: list[dict]) -> int:
        """Index of the decode replica to hand a prefilled request to."""
        return self._pick("decode", [
            slo_score(s["queue_depth"], s.get("active_slots", 0),
                      s["tpot_p95"], self.slo.tpot_s)
            for s in stats_list])
