"""One stats schema across the serving stack (DESIGN.md §11).

``ServingEngine.stats``, ``serve_lib.BatchServer.stats``, and
``ServingCluster.stats()`` all return the same typed dict, built here,
so the SLO router, ``launch/serve.py --metrics``, and the serving
benchmark consume one shape regardless of which component produced it.

Shared keys (always present, same meaning everywhere):

  requests_completed  int    requests fully served (not batches/steps)
  queue_depth         int    requests waiting for admission right now
  evictions           int    preempt-and-requeue events so far
  ttft_p50/p95/p99    float  seconds, submit -> first token exists
  tpot_p50/p95/p99    float  seconds, interval between consecutive
                             tokens of one request (per token)
  tokens_per_step     float  mean tokens emitted per occupied slot per
                             decode step — 1.0 on plain decode paths,
                             > 1.0 when speculation accepts drafts

Components may add extra keys (``prefix_hit_rate``, ``free_blocks``,
``spec_accept_rate`` — present only while speculating — ``batches``
...) but must not repurpose the shared ones.  Aggregates
nest their members' full stats dicts under ``replicas`` (name ->
stats); leaf components omit the key entirely.
"""
from __future__ import annotations

from repro_torch.telemetry import Histogram

SHARED_KEYS = (
    "requests_completed", "queue_depth", "evictions",
    "ttft_p50", "ttft_p95", "ttft_p99",
    "tpot_p50", "tpot_p95", "tpot_p99",
    "tokens_per_step",
)

_QS = (50, 95, 99)


def latency_fields(prefix: str, hist: Histogram) -> dict:
    """``{prefix}_p{50,95,99}`` seconds from one histogram."""
    return {f"{prefix}_p{q}": hist.percentile(q) for q in _QS}


def serving_stats(*, requests_completed: int, queue_depth: int,
                  evictions: int, ttft: Histogram, tpot: Histogram,
                  tokens_per_step: float = 1.0,
                  replicas: dict | None = None, **extra) -> dict:
    """Assemble one schema-conforming stats dict.

    ``ttft``/``tpot`` are the component's latency histograms (percentile
    keys are extracted here so every producer agrees on the quantiles);
    ``tokens_per_step`` defaults to 1.0 — the plain one-token decode
    tick — so only speculating producers need to pass it; ``extra``
    carries component-specific keys; ``replicas`` nests member
    breakdowns for aggregates."""
    overlap = set(extra) & set(SHARED_KEYS)
    if overlap:
        raise ValueError(f"extra keys shadow shared schema keys: {overlap}")
    s = {
        "requests_completed": int(requests_completed),
        "queue_depth": int(queue_depth),
        "evictions": int(evictions),
        **latency_fields("ttft", ttft),
        **latency_fields("tpot", tpot),
        "tokens_per_step": float(tokens_per_step),
        **extra,
    }
    if replicas is not None:
        s["replicas"] = dict(replicas)
    return s


def check_schema(s: dict) -> None:
    """Raise if ``s`` is missing shared keys (used by tests and the
    router, which trusts the schema instead of duck-typing)."""
    missing = [k for k in SHARED_KEYS if k not in s]
    if missing:
        raise KeyError(f"stats dict missing shared keys: {missing}")
    for name, sub in (s.get("replicas") or {}).items():
        try:
            check_schema(sub)
        except KeyError as e:
            raise KeyError(f"replica {name!r}: {e}") from None
